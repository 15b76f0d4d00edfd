"""Run the paper's jobs on the port and print one JSON line per job.

  PYTHONPATH=src python -m repro_torch.paper [--only a,b] [--full] [--list] [--device cpu]

The jobs and their sizes are the reference's ``benchmarks/run.py``'s
(``--full`` as there).  Each line is ``{"job": name, "result": ...}``, the
job's returned dict as ``repro_torch.data.paper_record`` writes it.  A
failed assert ends the run with a non-zero exit; there is no timing split
and no file is written.  Without ``--device`` the jobs run on the CUDA card.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.data import paper_record
from repro_torch.paper import job_table


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.paper")
    ap.add_argument("--full", action="store_true", help="the reference's --full sizes")
    ap.add_argument("--only", default=None, help="comma-separated job names to run")
    ap.add_argument("--list", action="store_true", help="print the job names and exit")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    jobs = job_table(args.full)
    valid = list(jobs)
    if args.list:
        print("\n".join(valid))
        return
    if args.only:
        wanted = args.only.split(",")
        unknown = set(wanted) - set(valid)
        if unknown:
            raise SystemExit(
                f"unknown --only jobs: {sorted(unknown)}; valid jobs: {valid} (see also --list)"
            )
        jobs = {k: v for k, v in jobs.items() if k in wanted}
    for name, (fn, kwargs) in jobs.items():
        out = fn(**kwargs, device=args.device)
        print(json.dumps({"job": name, "result": paper_record(out)}), flush=True)


if __name__ == "__main__":
    main()
