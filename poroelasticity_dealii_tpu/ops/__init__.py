"""Batched FEM compute: quadrature/shape tables, element operators, and
matrix-free operator applies (gather -> batched matvec -> segment_sum)."""
