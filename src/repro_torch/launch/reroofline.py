"""Recompute the roofline blocks of the dry run's saved records.

The counterpart of ``repro/launch/reroofline.py``, which re-analyzes saved
HLO. The port's records keep the tallies the roofline is made of
(``op_stats``: flops, bytes, and collective bytes by link), so the terms can
be recomputed with :mod:`repro_torch.launch.dryrun`'s constants, and the
useful-flops ratio with the record's ``model_flops``, without running a cell
again. Patches every ``ok`` record's ``roofline`` block in place.

  PYTHONPATH=src python -m repro_torch.launch.reroofline [--results DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Optional, Sequence

from repro_torch.launch.dryrun import RESULTS_DIR, roofline


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--results", default=None, help=f"records' root (default {RESULTS_DIR})")
    args = ap.parse_args(argv)
    root = pathlib.Path(args.results) if args.results else RESULTS_DIR
    n = 0
    for path in sorted(root.glob("*/*.json")):
        rec = json.loads(path.read_text())
        if rec.get("status") != "ok":
            continue
        rec["roofline"] = roofline(rec["op_stats"])
        flops = rec["op_stats"]["flops_per_device"] * rec["chips"]
        rec["useful_flops_ratio"] = rec["model_flops"] / flops if flops else None
        path.write_text(json.dumps(rec, indent=2))
        n += 1
        r = rec["roofline"]
        print(f"re-analyzed {path.parent.name}/{path.stem}: dominant={r['dominant']} "
              f"mem={r['memory_s']*1e3:.1f}ms comp={r['compute_s']*1e3:.1f}ms "
              f"coll={r['collective_s']*1e3:.1f}ms")
    print(f"{n} cells updated")
    return n


if __name__ == "__main__":
    main()
