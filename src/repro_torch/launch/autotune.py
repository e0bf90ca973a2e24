"""DSE-in-the-loop autotuning entry point — the counterpart of
``repro/launch/autotune.py``.

Closes the loop between the analytical half of the reproduction and the
serving runtime, per family:

  1. enumerate candidate execution configs (compaction block granularity,
     balance unit, MUX fan-in budget, Mode-selection threshold) fitted to
     the family's actual GEMM shapes (``tuning.search``);
  2. score them through the cycle-model DSE sweep (content-hashed
     ``ResultsCache`` — warm re-runs are free) and the roofline
     prediction of the compacted decode step;
  3. validate the predicted shortlist against measured tok/s on warm
     serving runs (``tuning.measure``), asserting candidate-vs-default
     token identity along the way;
  4. emit the winners as a versioned kernel plan consumed by
     ``sparsify_params(plan=...)`` and ``ServeEngine(plan=...)`` (and by
     the JAX package's, which reads the same schema).

    python -m repro_torch.launch.autotune --families dense

runs full-width llama3.2-1b on the CUDA card; ``--reduced --device cpu``
runs the reduced config on the host (the kernels' plain versions).

The emitted file is reloaded through ``tuning.load_plan`` before the
process exits, so a plan that would fail its own schema check can never
be written silently.
"""
from __future__ import annotations

import argparse
import os
from typing import Any

from ..core.dse import DEFAULT_CACHE_DIR, ResultsCache
from ..sparsity import prune_for, sparsify_params
from ..tuning import KernelPlan, load_plan
from ..tuning.measure import (FAMILY_ARCHS, TUNE_SLOTS, measure_plan,
                              tuning_workload)
from ..tuning.search import (enumerate_candidates, gemm_leaves,
                             predict_scores, select_best, shortlist)

DEFAULT_OUT = os.path.join("chiprun_out", "kernel_plan_torch.json")


def autotune_family(family: str, *, sparsity: float, budget: int,
                    shortlist_k: int, requests: int, repeats: int,
                    cache_dir: str = DEFAULT_CACHE_DIR, seed: int = 0,
                    reduced: bool = False, device: Any = "cuda"):
    """Run the full predict -> shortlist -> measure pipeline for one
    family on ``device`` (full width unless ``reduced``); returns
    (FamilyPlan, summary dict).  The summary carries every scored row
    (``scored``), the shortlist and each measured run."""
    cfg, api, params, cache_len, trace = tuning_workload(
        family, requests=requests, reduced=reduced, device=device)
    prune = prune_for(reduced)
    # pruned-but-uncompacted twin: the zero pattern every candidate shares
    # (plans steer compaction only) and the input to the roofline stats
    pruned = sparsify_params(params, sparsity, compact=False, **prune)
    leaves = gemm_leaves(pruned)
    if not leaves:
        raise ValueError(f"{family}: no GEMM leaves to tune")
    cands = enumerate_candidates(
        {k: tuple(w.shape) for k, w in leaves.items()}, budget)
    cache = ResultsCache(cache_dir) if cache_dir else None
    scored = predict_scores(cands, leaves, batch=TUNE_SLOTS, cache=cache,
                            seed=seed)
    del pruned, leaves
    short = shortlist(scored, shortlist_k)
    print(f"[{family}] {len(cands)} candidates -> shortlist "
          + ", ".join(f"{r['name']} (score {r['score']:.3g})"
                      for r in short))

    default_params = sparsify_params(params, sparsity, compact=True,
                                     **prune)
    base = measure_plan(api, default_params, cache_len, trace,
                        repeats=repeats)
    del default_params
    print(f"[{family}] default ({prune['block_k']}x{prune['block_n']}"
          f"/u{prune['unit']}): {base['tok_s']:.1f} tok/s, "
          f"mode {base['mode']}")

    measured_tok_s = {}
    by_name = {}
    for row in short:
        c = row["candidate"]
        fp = c.family_plan(cfg.family)
        p = sparsify_params(params, sparsity, compact=True, plan=fp,
                            **prune)
        m = measure_plan(api, p, cache_len, trace, plan=fp, repeats=repeats)
        del p
        assert m["tokens"] == base["tokens"], (
            f"{family}/{c.name}: tuned tokens diverged from default — a "
            "plan may change how GEMMs execute, never what they compute")
        measured_tok_s[c.name] = m["tok_s"]
        by_name[c.name] = (c, row, m)
        print(f"[{family}]   {c.name}: {m['tok_s']:.1f} tok/s "
              f"(predicted_s {row['predicted_s']:.3g}, "
              f"mode {m['mode']}) — tokens identical to default")

    winner = select_best(measured_tok_s)
    c, row, m = by_name[winner]
    predicted = {r["name"]: {"score": round(r["score"], 6),
                             "dse_speedup": r["dse_speedup"],
                             "grid_steps": r["grid_steps"],
                             "predicted_s": r["predicted_s"]}
                 for r in short}
    measured = {"default": {"tok_s": round(base["tok_s"], 1),
                            "tok_per_step": round(base["tok_per_step"], 3)},
                **{n: {"tok_s": round(mm[2]["tok_s"], 1),
                       "tok_per_step": round(mm[2]["tok_per_step"], 3)}
                   for n, mm in by_name.items()},
                "winner": winner,
                "winner_vs_default":
                    round(m["tok_s"] / max(base["tok_s"], 1e-9), 3)}
    fp = c.family_plan(cfg.family, predicted=predicted, measured=measured)
    summary = {"family": cfg.family, "arch": FAMILY_ARCHS[family],
               "winner": winner,
               "tok_s_default": base["tok_s"], "tok_s_tuned": m["tok_s"],
               "cache": (f"{cache.hits} hits / {cache.misses} misses"
                         if cache else "off"),
               "scored": scored, "shortlist": short, "default": base,
               "runs": {n: mm[2] for n, mm in by_name.items()}}
    print(f"[{family}] winner {winner}: {m['tok_s']:.1f} vs default "
          f"{base['tok_s']:.1f} tok/s "
          f"({measured['winner_vs_default']}x), dse cache "
          f"{summary['cache']}")
    return fp, summary


def write_plan(fams, meta, out: str) -> KernelPlan:
    """Save the plan to ``out`` and load it back through ``load_plan``: a
    plan this process cannot read (schema drift, a serialization bug)
    fails here, not at serve time.  Returns the reloaded plan."""
    plan = KernelPlan(families=fams, meta=meta)
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    plan.save(out)
    reloaded = load_plan(out)
    if set(reloaded.families) != set(fams) or \
            reloaded.families != plan.families:
        raise RuntimeError(f"{out}: the reloaded plan differs from the "
                           "one written")
    return reloaded


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--families", default="dense",
                    help="comma-separated model families "
                         f"(known: {','.join(sorted(FAMILY_ARCHS))})")
    ap.add_argument("--sparsity", type=float, default=0.8)
    ap.add_argument("--budget", type=int, default=16,
                    help="candidate points enumerated per family")
    ap.add_argument("--shortlist", type=int, default=3,
                    help="predicted shortlist size validated by "
                         "measurement")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed replays per measurement (best-of)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR,
                    help="DSE sweep ResultsCache directory ('' disables)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    families = [f.strip() for f in args.families.split(",") if f.strip()]
    unknown = [f for f in families if f not in FAMILY_ARCHS]
    if unknown:
        ap.error(f"unknown families {unknown} "
                 f"(known: {sorted(FAMILY_ARCHS)})")

    fams = {}
    summaries = []
    for family in families:
        fp, summary = autotune_family(
            family, sparsity=args.sparsity, budget=args.budget,
            shortlist_k=args.shortlist, requests=args.requests,
            repeats=args.repeats, cache_dir=args.cache_dir, seed=args.seed,
            reduced=args.reduced, device=args.device)
        fams[fp.family] = fp
        summaries.append(summary)

    reloaded = write_plan(fams, {
        "tool": "repro_torch.launch.autotune", "sparsity": args.sparsity,
        "budget": args.budget, "shortlist": args.shortlist,
        "requests": args.requests, "seed": args.seed,
        "prune": prune_for(args.reduced), "reduced": args.reduced,
        "device": args.device,
        "archs": {f: FAMILY_ARCHS[f] for f in families}}, args.out)
    print(f"kernel plan -> {args.out} "
          f"(schema v{reloaded.schema_version}, "
          f"families {sorted(reloaded.families)})")
    for s in summaries:
        print(f"  {s['family']}: {s['winner']} "
              f"{s['tok_s_tuned']:.1f} tok/s vs default "
              f"{s['tok_s_default']:.1f}")


if __name__ == "__main__":
    main()
