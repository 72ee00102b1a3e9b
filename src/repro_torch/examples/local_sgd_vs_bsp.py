"""Local SGD [73] / post-local SGD [121] against BSP: loss against
synchronization rounds, the communication-frequency dimension of the
taxonomy (section III), declared as scenarios on the trainer substrate (the
twin of ``examples/local_sgd_vs_bsp.py``; 8 workers stacked on one device).

    PYTHONPATH=src python -m repro_torch.examples.local_sgd_vs_bsp [--device cpu]
"""

import argparse

from repro_torch.experiments import Scenario
from repro_torch.experiments.trainer_substrate import run_trainer_sweep
from repro_torch.train.steps import bundle_cache_stats

STEPS = 160
BASE = dict(n_workers=8, steps=STEPS, lr=0.15)

RUNS = [
    ("BSP (sync every step)", Scenario(sync="bsp", **BASE)),
    ("Local SGD H=4", Scenario(sync="local", local_steps=4, **BASE)),
    ("Local SGD H=16", Scenario(sync="local", local_steps=16, **BASE)),
    ("post-local (BSP 80 -> H=8)", Scenario(sync="post_local", local_steps=8,
                                            post_local_switch=80, **BASE)),
]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="default cuda; cpu to run without a card")
    args = p.parse_args(argv)
    # one class-grouped sweep: H=4 and H=16 share a bundle build (H is the
    # trainer's step-count decision, not program structure)
    results, _ = run_trainer_sweep([s for _, s in RUNS], device=args.device)
    print(f"{'scheme':28s} {'final loss':>10s} {'sync rounds':>12s}")
    for (name, _), res in zip(RUNS, results):
        print(f"{name:28s} {res.measured['final_loss']:10.4f} "
              f"{int(res.measured['sync_rounds']):12d}")
    st = bundle_cache_stats()
    print(f"bundle builds: {st.builds} for {len(RUNS)} cells ({st.hits} cache hits)")
    print("LOCAL-SGD OK")


if __name__ == "__main__":
    main()
