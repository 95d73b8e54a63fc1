"""A/B of the port's one-device train step on a GPU: 20 bf16 steps of
smollm-360m at full width and depth (batch 8 x 256) through
``launch/train.py``'s ``Trainer``, with ``repro_torch`` imported from the
``src`` directory given as the first argument. Prints one JSON line: the
median and least step time over steps 3-20 and the first and last losses.
To compare two trees on one card, unpack the other into ``_parent/`` and
run them alternately, each in its own process:

    for s in _parent/src src src _parent/src; do
        python3 tools/train_step_ab.py $s; done
"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.configs import get_config
from repro_torch.launch.train import Trainer, run_config

tr = Trainer(get_config("smollm-360m"), run_config(), seq=256, batch=8,
             lr=3e-3, seed=0, device="cuda")
ts, losses = [], []
for i in range(20):
    torch.cuda.synchronize(); t0 = time.perf_counter()
    losses.append(float(tr.step(i)["loss"]))
    torch.cuda.synchronize(); ts.append(time.perf_counter() - t0)
st = sorted(ts[2:])
print(json.dumps({"src": sys.argv[1], "median_ms": 1e3 * st[len(st) // 2],
                  "min_ms": 1e3 * st[0], "losses": losses[:3] + losses[-2:]}))
