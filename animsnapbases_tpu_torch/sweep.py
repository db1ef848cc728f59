"""A parallel sweep of bases configs: ``python -m
animsnapbases_tpu_torch.sweep CONFIG.json ... [--jobs N] [--per-card]
[--cpu] [--results_dir DIR]``.

Counterpart of ``scripts/sweep.py``: each config runs as its own worker
process of the port's bases CLI (``python -m animsnapbases_tpu_torch.cli
--config_file ...``), up to ``--jobs`` at once; with ``--per-card`` worker
i sees only card i mod the cards present (``CUDA_VISIBLE_DEVICES``, where
the JAX script sets ``JAX_VISIBLE_DEVICES``); ``--cpu`` passes ``--cpu`` to
every worker.  The workers run in the caller's directory, so relative
paths in the configs resolve as they would for the CLI itself.  Prints
``sweep: k/n configs ok`` and the failed configs; exits 1 if any failed.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_config(cfg: str, device: int | None, extra: list[str]):
    """One worker of the bases CLI on ``cfg`` -> (cfg, exit code)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    if device is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(device)
    proc = subprocess.run(
        [sys.executable, "-m", "animsnapbases_tpu_torch.cli",
         "--config_file", cfg, *extra],
        env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(f"--- {cfg} FAILED ---\n{proc.stderr[-2000:]}\n")
    return cfg, proc.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run bases configs in "
                                             "parallel worker processes.")
    ap.add_argument("configs", nargs="+")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--per-card", action="store_true",
                    help="pin worker i to card i %% the cards present")
    ap.add_argument("--cpu", action="store_true",
                    help="compute the bases on the CPU (default: the card)")
    ap.add_argument("--results_dir", type=str, default=None)
    args = ap.parse_args(argv)

    n_cards = 1
    if args.per_card:
        import torch

        n_cards = max(torch.cuda.device_count(), 1)
    extra = (["--cpu"] if args.cpu else []) + (
        ["--results_dir", args.results_dir] if args.results_dir else [])
    with ThreadPoolExecutor(max_workers=max(args.jobs, 1)) as pool:
        futures = [pool.submit(run_config, cfg,
                               i % n_cards if args.per_card else None, extra)
                   for i, cfg in enumerate(args.configs)]
        results = [fut.result() for fut in futures]

    failed = [cfg for cfg, rc in results if rc != 0]
    print(f"sweep: {len(results) - len(failed)}/{len(results)} configs ok",
          flush=True)
    if failed:
        print("failed:", *failed, sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
