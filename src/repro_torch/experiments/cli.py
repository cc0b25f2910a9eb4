"""Experiment CLI (the port of ``repro.experiments.cli``).

    PYTHONPATH=src python -m repro_torch.experiments.cli list
    PYTHONPATH=src python -m repro_torch.experiments.cli show <sweep>
    PYTHONPATH=src python -m repro_torch.experiments.cli run <sweep> \
        [--out experiments/runs] [--steps N] [--seeds K] \
        [--checkpoint-every N] [--fresh] [--mesh [data|2d]] [--device cpu]
    PYTHONPATH=src python -m repro_torch.experiments.cli table <sweep> \
        [--out experiments/runs] [--burn-in N]

``run`` is resumable by default: re-invoking it after a kill skips recorded
runs and resumes the interrupted one from its checkpoint. It trains on the
card unless ``--device cpu``. Under a launcher that sets ``WORLD_SIZE`` and
``RANK`` (``torchrun --nproc-per-node N``) every rank joins one gloo
process group, and ``--mesh`` fans the runs over the ranks (see
``runner._mesh_for``).
"""
from __future__ import annotations

import argparse

from repro_torch.experiments import metrics as M
from repro_torch.experiments.metrics import ResultsStore
from repro_torch.experiments.registry import SWEEPS, get_sweep
from repro_torch.experiments.runner import run_sweep


def _sweep_overrides(args) -> dict:
    kw = {}
    if args.steps:
        kw["steps"] = args.steps
    if args.seeds:
        kw["seeds"] = tuple(range(args.seeds))
    if args.mesh:
        kw["use_mesh"] = args.mesh   # "data" (1-D) or "2d" (data x model)
    return kw


def cmd_list(_args) -> None:
    for name, factory in sorted(SWEEPS.items()):
        doc = (factory.__doc__ or "").strip().splitlines()[0]
        print(f"{name:>22s}  {doc}")


def cmd_show(args) -> None:
    sweep = get_sweep(args.sweep, **_sweep_overrides(args))
    for spec in sweep.expand():
        print(f"{spec.run_id}  {spec.method:>14s}  b={spec.batch_size:<5d} "
              f"seed={spec.seed} steps={spec.regime().total_steps}")


def cmd_run(args) -> None:
    from repro_torch.launch.mesh import init_distributed
    init_distributed()
    sweep = get_sweep(args.sweep, **_sweep_overrides(args))
    records = run_sweep(sweep, args.out, resume=not args.fresh,
                        checkpoint_every=args.checkpoint_every,
                        log_fn=print, device=args.device)
    print(f"\n{len(records)} records in {args.out}/{sweep.name}/"
          f"records.jsonl")
    _print_views(records, burn_in=2)


def cmd_table(args) -> None:
    sweep_name = args.sweep
    store = ResultsStore(f"{args.out}/{sweep_name}")
    records = store.records()
    if not records:
        print(f"no records under {store.path}")
        return
    _print_views(records, burn_in=args.burn_in)


def _print_views(records, *, burn_in: int) -> None:
    acc_rows = M.table1_view([r for r in records if "final_acc" in r])
    if acc_rows:
        print("\n== Table-1 view ==")
        print(M.format_table1(acc_rows))
    diff_rows = M.diffusion_view(records, burn_in=burn_in)
    if diff_rows:
        print("\n== diffusion fits ==")
        print(M.format_diffusion(diff_rows))
    lm = [r for r in records if "final_ce" in r]
    if lm:
        print("\n== LM runs ==")
        for r in lm:
            print(f"{r['method']:>14s} b={r['batch_size']:<5d} "
                  f"seed={r['seed']} ce={r['final_ce']:.4f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.experiments.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list")

    def _common(p):
        p.add_argument("sweep", choices=sorted(SWEEPS))
        p.add_argument("--steps", type=int, default=0)
        p.add_argument("--seeds", type=int, default=0,
                       help="number of seeds (0..K-1)")
        p.add_argument("--mesh", nargs="?", const="data", default="",
                       choices=["data", "2d"],
                       help="fan runs over a mesh when usable: 'data' "
                            "(1-D, the default when the flag is bare) or "
                            "'2d' (data x model)")

    p = sub.add_parser("show")
    _common(p)
    p = sub.add_parser("run")
    _common(p)
    p.add_argument("--out", default="experiments/runs")
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--fresh", action="store_true",
                   help="discard existing records and rerun everything")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the card)")
    p = sub.add_parser("table")
    p.add_argument("sweep")
    p.add_argument("--out", default="experiments/runs")
    p.add_argument("--burn-in", type=int, default=2)

    args = ap.parse_args(argv)
    {"list": cmd_list, "show": cmd_show, "run": cmd_run,
     "table": cmd_table}[args.cmd](args)


if __name__ == "__main__":
    main()
