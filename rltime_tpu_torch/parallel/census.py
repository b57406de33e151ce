"""A count of the collectives the port issues.

Counterpart of `rltime_tpu/utils/hlo_census.py`, which reads the
collectives out of a compiled XLA program's HLO text. PyTorch compiles
no program to read, so `parallel/mesh.py:Mesh`, the only caller of
`torch.distributed` in the port, records each collective here as it
issues it: the op, the dtype, the bytes of the payload, the group it
ran on ("device" or "host") and the site that asked for it ("grad",
"metrics", "max_priority", "stats", ...). The counts are keyed, so a
long run holds one entry per distinct collective, not one per call.
Tests and `chip_smoke.py` zero them with `reset_counts()` before a
step and read `entries()` after it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# (op, dtype, bytes, group, site) -> times issued
COUNTS: Dict[Tuple[str, str, int, str, str], int] = {}


def record(op: str, dtype: str, nbytes: int, group: str, site: str) -> None:
    key = (op, dtype, int(nbytes), group, site)
    COUNTS[key] = COUNTS.get(key, 0) + 1


def reset_counts() -> None:
    COUNTS.clear()


def entries() -> List[dict]:
    """One dict per distinct collective: op, dtype, bytes, group, site,
    count; ordered by site, then op."""
    return [dict(op=op, dtype=dt, bytes=nb, group=g, site=site, count=n)
            for (op, dt, nb, g, site), n in sorted(
                COUNTS.items(), key=lambda kv: (kv[0][4], kv[0][0]))]


def summarize(ents: List[dict] | None = None) -> str:
    ents = entries() if ents is None else ents
    return "\n".join(f"{e['count']:6d} x {e['op']:<10} {e['dtype']:<9} "
                     f"{e['bytes']:>12} B  {e['group']:<6} {e['site']}"
                     for e in ents) or "(no collectives)"
