"""Command-line interface.

``python -m poroelasticity_dealii_tpu run input.data`` — the analogue of the
reference's ``./code input.data`` (``parse_command_line.h:5-27`` + the
``main()`` template at ``PoroelasticityFSS.h:504-537``), with subcommands for
validation and device inspection.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="poroelasticity_dealii_tpu",
        description="Biot poroelasticity solver (fixed-stress splitting)")
    sub = parser.add_subparsers(dest="command", required=True)

    run_p = sub.add_parser("run", help="run a simulation from a deck file")
    run_p.add_argument("deck", help="parameter deck (.data/.prm)")
    run_p.add_argument("--resume", default=None,
                       help="checkpoint .npz to resume from")
    run_p.add_argument("--x64", action="store_true",
                       help="force float64 (overrides deck TPU/Dtype)")
    run_p.add_argument("--platform", default=None,
                       help="jax platform override (cpu/gpu)")
    run_p.add_argument("--profile", default=None, metavar="LOGDIR",
                       help="capture a TensorBoard device trace of the run")

    chk = sub.add_parser("check", help="parse + validate a deck, print it")
    chk.add_argument("deck")

    sub.add_parser("devices", help="list visible accelerator devices")

    args = parser.parse_args(argv)

    if args.command == "check":
        from .config import format_deck, read_input_file
        data = read_input_file(args.deck)
        sys.stdout.write(format_deck(data))
        print(f"# derived: lambda={data.lame_constant:.6g} "
              f"G={data.shear_modulus:.6g} K={data.bulk_modulus:.6g} "
              f"Ks={data.grain_bulk_modulus:.6g} N={data.n_modulus:.6g} "
              f"M={data.m_modulus:.6g}")
        return 0

    import jax

    if args.command == "devices":
        for d in jax.devices():
            print(d)
        return 0

    # run
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import dataclasses

    from .config import read_input_file
    data = read_input_file(args.deck)
    if args.x64:
        # force f64 end to end: the solver arrays follow data.dtype, not
        # just the jax x64 switch
        data = dataclasses.replace(data, dtype="float64")
    if data.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    from .models.runner import run_from_data

    def go():
        run_from_data(data, resume_from=args.resume)

    if args.profile:
        from .utils.profiling import device_trace
        with device_trace(args.profile):
            go()
    else:
        go()
    return 0


if __name__ == "__main__":
    sys.exit(main())
