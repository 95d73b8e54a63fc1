"""The metric `wkv6_decode_roofline`: the RWKV6 decode step's kernel (K3d,
``wkv6_decode_kernel``), its least time for the calls of the traced slice
over its device time there, in per cent.

Every layer of every traced step is one call over all the batcher's
slots. A slot whose given length is 0 reads no state, so a step's bytes
count the state read only for the slots at another length
(``costs.wkv6_decode_cost``; its operations are fp32, against the fp32
peak). None unless the trace holds exactly one launch a layer of each
traced step."""
from __future__ import annotations

from typing import Optional

from harness import costs
from harness.readers import kernel_time

KERNEL = "wkv6_decode_kernel"


def read(rec) -> Optional[float]:
    s = rec.spec
    n_l = s["num_hidden_layers"]
    seconds, launches = kernel_time(rec, KERNEL)
    if not seconds or launches != n_l * len(rec.k1_lens):
        return None
    hd = s["head_size"]
    item = costs.ITEM[s["torch_dtype"]]
    least_ms = 0.0
    for lens in rec.k1_lens:
        live = sum(1 for n in lens if n != 0)
        cost = costs.wkv6_decode_cost(len(lens), s["hidden_size"] // hd, hd,
                                      hd, item, live)
        least_ms += n_l * costs.bound(*cost, "float32")["bound_ms"]
    return 100.0 * least_ms / (1e3 * seconds)
