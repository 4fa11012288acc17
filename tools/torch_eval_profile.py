"""Where the port's link-prediction time goes on a CUDA card.

Ranks the test split of an FB15K-237-shaped KG (TransE d=200, seeded
random tables) through ``openkeonspark_tpu_torch.eval.link_prediction``,
for p=1 and p=2: the eval throughput at each chunk size (median of 5 runs,
host clock), then one run at the default chunk under ``torch.profiler``
with the device time by kernel, the device busy share and a chrome trace
in ``--out``.

    python tools/torch_eval_profile.py --chunks 256,1024,4096
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from openkeonspark_tpu_torch.config import Config  # noqa: E402
from openkeonspark_tpu_torch.data import build_kg_index, fb15k237_like  # noqa: E402
from openkeonspark_tpu_torch.eval import link_prediction  # noqa: E402
from openkeonspark_tpu_torch.models import TransE, init_tables  # noqa: E402
from openkeonspark_tpu_torch.runtime import eval_chunk_size  # noqa: E402

DIM = 200
REPEATS = 5


def device_us(e) -> float:
    # the attribute's name changed across torch versions
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, name):
            return getattr(e, name)
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunks", default="256",
                    help="comma-separated eval chunk sizes to time")
    ap.add_argument("--out", default="build/traces",
                    help="directory for the chrome traces")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    os.makedirs(args.out, exist_ok=True)
    ds = fb15k237_like(args.seed)
    idx = build_kg_index(ds, for_eval=True)

    for p in (1, 2):
        cfg = Config(model="transe", hidden_size=DIM, p_norm=p)
        params = init_tables(torch.Generator().manual_seed(args.seed),
                             TransE.tables(cfg, ds.n_ent, ds.n_rel), dev)
        for chunk in map(int, args.chunks.split(",")):
            c = cfg.replace(eval_chunk=chunk)
            link_prediction(params, c, ds, idx)                 # warm-up
            ts = []
            for _ in range(REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                link_prediction(params, c, ds, idx)
                ts.append(time.perf_counter() - t0)
            print(f"p={p} chunk={chunk}: runs "
                  f"{', '.join(f'{t:.4f}' for t in sorted(ts))} s -> "
                  f"{ds.n_test / float(np.median(ts)):.1f} test triples/s "
                  f"(median) on {card}")

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            link_prediction(params, cfg, ds, idx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        busy = sum(device_us(e) for e in ka) / 1e6
        print(f"p={p} chunk={eval_chunk_size(cfg)} profiled: wall "
              f"{wall:.4f} s, device busy {busy:.4f} s "
              f"({100 * busy / wall:.1f}%, profiler on)")
        for us, key, n in sorted(((device_us(e), e.key, e.count) for e in ka
                                  if device_us(e) > 0), reverse=True)[:12]:
            print(f"  device {us / 1e3:9.3f} ms {n:6d}x  {key[:80]}")
        for us, key, n in sorted(((e.self_cpu_time_total, e.key, e.count)
                                  for e in ka), reverse=True)[:8]:
            print(f"  host   {us / 1e3:9.3f} ms {n:6d}x  {key[:80]}")
        prof.export_chrome_trace(os.path.join(args.out,
                                              f"eval_trace_p{p}.json"))


if __name__ == "__main__":
    main()
