"""Generation rate of the native host sampler alone, across thread counts.

Counterpart of ``tools/sampler_bench.py`` (``:30-80``) over the port's
``sampling/host.py::HostSampler`` (``sample_flat``), whose library is
built with g++ from ``native/sampler.cpp`` into the port's build tree:
host-side only, no copy to the device, on the flagship-shaped store, so
the host-sampler crossover can state whether a co-located host can feed a
card. ``--device`` names the machine's card in the output (the sampler
never touches it).

Usage: python -m openkeonspark_tpu_torch.tools.sampler_bench
           [--batch 2721] [--threads 1,2,4,8,16] [--device cuda]
Prints one JSON line per thread count + a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from openkeonspark_tpu_torch.data import build_kg_index, random_kg
from openkeonspark_tpu_torch.tools import add_device_flag, open_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2721)
    ap.add_argument("--negative-ent", type=int, default=1)
    ap.add_argument("--threads", default="1,2,4,8,16")
    ap.add_argument("--n-ent", type=int, default=14541)
    ap.add_argument("--n-train", type=int, default=272115)
    ap.add_argument("--steps", type=int, default=50)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    _, label = open_device(args.device)

    from openkeonspark_tpu_torch.sampling.host import HostSampler

    ds = random_kg(n_ent=args.n_ent, n_rel=237, n_triples=args.n_train,
                   n_valid=1000, n_test=1000, seed=7)
    index = build_kg_index(ds, for_eval=False)

    lines, results = [], {}
    for nt in [int(x) for x in args.threads.split(",")]:
        host = HostSampler(ds, index, n_threads=nt)
        # warm (page in the index arrays)
        host.sample_flat(0, args.batch, args.negative_ent, 0, True)
        rates = []
        for run in range(5):
            t0 = time.perf_counter()
            for s in range(args.steps):
                host.sample_flat(run * args.steps + s + 1, args.batch,
                                 args.negative_ent, 0, True)
            rates.append(args.steps * args.batch
                         / (time.perf_counter() - t0))
        med = float(np.median(rates))
        results[nt] = med
        rec = {"threads": nt, "positives_per_sec": round(med, 1),
               "spread": round(float((max(rates) - min(rates)) / med), 3)}
        print(json.dumps(rec), flush=True)
        lines.append(rec)
        del host

    best_nt = max(results, key=results.get)
    summary = {
        "metric": "host_sampler_generation_rate",
        "batch": args.batch, "negative_ent": args.negative_ent,
        "n_ent": args.n_ent, "n_train": args.n_train,
        "host_cpus": os.cpu_count(),
        "best_threads": best_nt,
        "best_positives_per_sec": round(results[best_nt], 1),
        "per_thread_scaling": {str(k): round(v / results[min(results)], 2)
                               for k, v in sorted(results.items())},
        "device": label,
    }
    print(json.dumps(summary), flush=True)
    lines.append(summary)
    return lines


if __name__ == "__main__":
    main()
