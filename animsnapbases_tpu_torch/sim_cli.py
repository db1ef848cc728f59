"""Simulation CLI: ``python -m animsnapbases_tpu_torch.sim_cli``.

Counterpart of ``animsnapbases_tpu/sim_cli.py``, with its arguments:
chooses a scripted scenario by name and runs it headlessly, recording
snapshots when asked (``--record``, ``--record-positions``,
``--record-screenshots``), or with ``--view`` (or ``--example
interactive``) opens the live polyscope app on an
:class:`~animsnapbases_tpu_torch.demos.interactive.InteractiveSession`.
The solvers run on the card; without one the run raises, unless
``--cpu`` asks for the CPU.  Drawing needs ``matplotlib``
(``--record-screenshots``) and ``--view`` needs ``polyscope``.
"""

from __future__ import annotations

import argparse

from animsnapbases_tpu_torch.config.sim_config import SimConfig
from animsnapbases_tpu_torch.demos.scenarios import SCENARIOS, build_scenario


def cli(argv=None):
    parser = argparse.ArgumentParser(description="Projective dynamics demos")
    parser.add_argument("--example", type=str, default="testing",
                        choices=sorted(SCENARIOS) + ["interactive"])
    parser.add_argument("--view", action="store_true",
                        help="launch the live polyscope app (shift-click "
                             "pins, ctrl-drag applies force, the imgui "
                             "panel toggles constraints and gravity) "
                             "instead of the headless scripted run")
    parser.add_argument("--steps-per-frame", type=int, default=1,
                        help="solver steps per rendered frame (--view)")
    parser.add_argument("--system", type=str, default=None,
                        choices=("Cloth", "Bar"),
                        help="interactive system (--view); default follows "
                             "the example name (bar_* -> Bar, else Cloth)")
    parser.add_argument("--config", type=str,
                        default="configs/demos/testing.json")
    parser.add_argument("--solver", type=str, default=None,
                        choices=("Solver", "animSnapBasesSolver"),
                        help="override the config's solver (FOM recording "
                             "uses Solver, reduced replay "
                             "animSnapBasesSolver)")
    parser.add_argument("--record", action="store_true",
                        help="record constraint-projection snapshots")
    parser.add_argument("--record-positions", action="store_true",
                        help="also export pos_%%d.off position snapshots")
    parser.add_argument("--record-screenshots", action="store_true",
                        help="render every simulated frame to a PNG "
                             "(headless, matplotlib)")
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="run the solvers on the CPU (default: the "
                             "card, which must be present)")
    parser.add_argument("--list", action="store_true",
                        help="list available scenarios and exit")
    args_ns = parser.parse_args(argv)

    if args_ns.list:
        for name in sorted(SCENARIOS):
            print(name)
        return None

    device = "cpu" if args_ns.cpu else None
    params = SimConfig(args_ns.config)
    if args_ns.view or args_ns.example == "interactive":
        # the live loop: InteractiveSession holds the model, solver and
        # panel state, PolyscopeViewer renders it and forwards mouse and
        # imgui events to the session's handlers
        from animsnapbases_tpu_torch.analysis.ps_viewer import show_session
        from animsnapbases_tpu_torch.demos.interactive import (
            InteractiveSession,
        )

        system = args_ns.system or (
            "Bar" if args_ns.example.startswith("bar") else "Cloth")
        sim_args = params.build_args(system)
        if args_ns.solver is not None:
            sim_args.solver = args_ns.solver
        session = InteractiveSession(sim_args, system=system, params=params,
                                     device=device)
        show_session(session, steps_per_frame=args_ns.steps_per_frame)
        return session

    sim_args = params.build_args()
    if args_ns.solver is not None:
        sim_args.solver = args_ns.solver
    if args_ns.output is not None:
        sim_args.output_dir = args_ns.output

    driver = build_scenario(args_ns.example, sim_args,
                            record_fom_info=args_ns.record, params=params,
                            record_positions=args_ns.record_positions,
                            record_screenshots=args_ns.record_screenshots,
                            device=device)
    driver.run(max_frames=args_ns.max_frames)
    print(f"scenario '{args_ns.example}' finished at frame "
          f"{driver.solver.frame}")
    return driver


if __name__ == "__main__":
    cli()
