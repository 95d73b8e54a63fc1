"""Which collectives a step runs, how many bytes each, over how many ranks.

Counterpart of ``repro.launch.hlo_parse``. The reference answers the
question by parsing the optimized HLO of a compiled step for its
collective ops. Eager PyTorch compiles no HLO: the port's collectives are
the calls in ``models/sharding.py``, and each notes itself into the
active ``sharding.CollectiveLog`` as it runs. So this module reads
that log instead of parsing text, and is named for what it returns rather
than for a format the port does not have. A record is the reference's:
``{"kind", "bytes", "group"}``, the kind under the HLO's name
(``all-reduce``, ``all-gather``; the port runs no reduce-scatter or
all-to-all: an ``all_gather_rs`` backward is an all-reduce and a slice),
the bytes those of the result buffer.

    with record_collectives() as records:
        step(...)
    summarize(records)   # {kind: {"count", "bytes", "group"}}
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

from repro_torch.models import sharding as S


@contextlib.contextmanager
def record_collectives():
    """The collectives run inside the block, as a list of records
    filled while it runs."""
    log = S.CollectiveLog()
    with S.log_collectives(log):
        yield log.records


def summarize(records: List[dict]) -> Dict[str, dict]:
    """Per kind, the count, the summed bytes and the group size (the last
    seen), as ``repro.launch.dryrun._collect`` builds it."""
    summary: Dict[str, dict] = {}
    for c in records:
        s = summary.setdefault(c["kind"], {"count": 0, "bytes": 0})
        s["count"] += 1
        s["bytes"] += c["bytes"]
        s["group"] = c["group"] or s.get("group")
    return summary
