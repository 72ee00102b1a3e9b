"""Decentralized (gossip) training: D-PSGD [51] and CHOCO-SGD [164]
(compressed gossip) against centralized BSP, on an 8-worker ring, declared
as scenarios on the trainer substrate (the twin of
``examples/gossip_decentralized.py``; the workers stacked on one device).

    PYTHONPATH=src python -m repro_torch.examples.gossip_decentralized [--device cpu]
"""

import argparse

from repro_torch.experiments import Scenario
from repro_torch.experiments.trainer_substrate import run_trainer_sweep
from repro_torch.train.steps import bundle_cache_stats

BASE = dict(n_workers=8, steps=120, lr=0.2)

RUNS = [
    ("BSP (centralized)", Scenario(**BASE)),
    ("D-PSGD ring gossip", Scenario(arch="gossip", **BASE)),
    ("CHOCO-SGD topk-10%", Scenario(arch="gossip", gossip_compress="choco",
                                    compressor="topk", compressor_kwargs={"ratio": 0.1},
                                    **BASE)),
]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="default cuda; cpu to run without a card")
    args = p.parse_args(argv)
    results, _ = run_trainer_sweep([s for _, s in RUNS], momentum=0.9, log_every=30,
                                   device=args.device)
    for (name, _), res in zip(RUNS, results):
        print(f"{name:22s} loss: " + " -> ".join(f"{v:.3f}" for v in res.series["loss"]))
    st = bundle_cache_stats()
    print(f"bundle builds: {st.builds} for {len(RUNS)} cells ({st.hits} cache hits)")
    print("GOSSIP OK")


if __name__ == "__main__":
    main()
