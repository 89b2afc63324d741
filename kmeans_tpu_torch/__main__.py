"""The command line: ``python -m kmeans_tpu_torch <command>``.

Counterpart of ``kmeans_tpu/__main__.py``, command for command.  With no
command it runs the original project's tests A to E (``suite``).  ``lint``
runs the invariant linter (``analysis``), which reads the sources and
touches no device.  The commands that read the benchmark's files, ``bench``
and ``bench-diff``, are not ported yet: each exits 2 naming the item of
ROADMAP.md that ports it.
"""

import sys

#: Commands of the reference that the port does not run yet, and the
#: ROADMAP item that ports each.
NOT_PORTED = {"bench": "A.15", "bench-diff": "A.15"}

COMMANDS = ("suite", "bench", "fit", "sweep", "ckpt-info", "warm", "serve",
            "report", "lint", "trace", "cost-report", "fleet-status",
            "serve-status", "bench-diff", "plan", "autopilot")


def main() -> int:
    args = sys.argv[1:]
    cmd = args[0] if args and not args[0].startswith("-") else "suite"
    rest = args[1:] if args and not args[0].startswith("-") else args
    if cmd in NOT_PORTED:
        print(f"error: '{cmd}' is not ported to kmeans_tpu_torch yet "
              f"(ROADMAP {NOT_PORTED[cmd]})", file=sys.stderr)
        return 2
    if cmd == "suite":
        from kmeans_tpu_torch.suite import main as suite_main
        return suite_main(rest)
    if cmd == "report":
        from kmeans_tpu_torch.utils.diagram import main as report_main
        return report_main(rest)
    mains = {"fit": "main", "sweep": "sweep_main",
             "ckpt-info": "ckpt_info_main", "warm": "warm_main",
             "serve": "serve_main", "trace": "trace_main",
             "cost-report": "cost_report_main",
             "fleet-status": "fleet_status_main",
             "serve-status": "serve_status_main", "plan": "plan_main",
             "autopilot": "autopilot_main", "lint": "lint_main"}
    if cmd in mains:
        from kmeans_tpu_torch import cli
        return getattr(cli, mains[cmd])(rest)
    print(f"unknown command {cmd!r}; available: {', '.join(COMMANDS)}",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
