"""Compression-scheme bake-off (the survey's Table IV, end to end): the same
model trained under each compression family, loss against per-step wire
bytes, as scenarios on the trainer substrate (the twin of
``examples/compression_comparison.py``).

Both run a 4-way data x 2-way model layout (``model_par=2``): here the 4
workers and the 2 model shards are stacked on one device, each (worker,
shard) compressing its shard-local buckets.

    PYTHONPATH=src python -m repro_torch.examples.compression_comparison [--device cpu]
"""

import argparse

from repro_torch.experiments import Scenario
from repro_torch.experiments.trainer_substrate import run_trainer_sweep
from repro_torch.train.steps import bundle_cache_stats

STEPS = 120
BASE = dict(n_workers=4, steps=STEPS)

CELLS = [
    ("dense_bsp        (32 bit)", Scenario(lr=0.3, **BASE)),
    ("qsgd s=4         (~3 bit)", Scenario(compressor="qsgd", compressor_kwargs={"levels": 4},
                                           lr=0.3, **BASE)),
    ("qsgd s=16        (~5 bit)", Scenario(compressor="qsgd", compressor_kwargs={"levels": 16},
                                           lr=0.3, **BASE)),
    ("terngrad         (~2 bit)", Scenario(compressor="terngrad",
                                           compressor_kwargs={"clip_sigma": 2.5}, lr=0.1,
                                           **BASE)),
    ("signsgd majority (1 bit) ", Scenario(compressor="signsgd", lr=0.02, **BASE)),
    ("topk 5% + EF             ", Scenario(compressor="topk", compressor_kwargs={"ratio": 0.05},
                                           error_feedback=True, lr=0.1, **BASE)),
    ("gtopk 5% + EF            ", Scenario(compressor="gtopk", compressor_kwargs={"ratio": 0.05},
                                           error_feedback=True, lr=0.1, **BASE)),
    ("local SGD H=8            ", Scenario(sync="local", local_steps=8, lr=0.1, **BASE)),
]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="default cuda; cpu to run without a card")
    args = p.parse_args(argv)
    # one class-grouped sweep: the two qsgd cells differ only in the levels
    # knob and share one bundle build
    results, _ = run_trainer_sweep([s for _, s in CELLS], data_par=4, model_par=2,
                                   device=args.device)
    print(f"{'scheme':28s} {'final loss':>10s} {'agg wire/step':>14s}")
    for (name, _), res in zip(CELLS, results):
        print(f"{name:28s} {res.measured['final_loss']:10.4f} "
              f"{res.measured['wire_kb_per_step']:11.1f}KB")
    st = bundle_cache_stats()
    print(f"bundle builds: {st.builds} for {len(CELLS)} cells ({st.hits} cache hits)")
    print("COMPARISON OK")


if __name__ == "__main__":
    main()
