"""How often the port's encoder takes its overflow path on the corpus, over
texts drawn from many seeds: how a configuration's fixed ``text_seed`` is
chosen.

    python3 flatebench/text_survey.py --config titles-pgzf64k
        --text-seeds 1-24 [--device cuda]

For each text seed the configuration's whole corpus is made with that
``text_seed`` and written once by ``pgzf.compress``.  A batch whose parse
overflows its slot budget is encoded again, one more ``sort_keys`` launch
than the corpus has batches.  Each text prints one JSON line (overflowing
batches, stream ratio, seconds); the last line gives the mean count over
the texts and the first text seed, in the order given, whose count is
that mean rounded up: the text the configuration fixes, which pays for
the overflow path once where a text takes it less than once on the
mean.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def seeds(spec: str) -> list:
    out = []
    for part in spec.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--text-seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from flatebench import harness
    from libflate_tpu_torch.formats import pgzf
    from libflate_tpu_torch.ops import sort_match

    cfg = harness.load_json(ROOT / "flatebench" / "configs"
                            / f"{args.config}.json")
    gen = harness.plugin("corpora", cfg["corpus"]["generator"])
    ms, piece = cfg["member_size"], cfg["corpus"]["piece_bytes"]
    batches = -(-cfg["corpus_bytes"] // (ms * 128))
    counts = {}
    for s in seeds(args.text_seeds):
        params = dict(cfg["corpus"], text_seed=s)
        text = b"".join(gen.make(params, cfg["corpus_bytes"] // piece,
                                 piece))
        before = sort_match.sort_keys.launches
        t = time.perf_counter()
        stream = pgzf.compress(text, member_size=ms, device=args.device)
        dt = time.perf_counter() - t
        counts[s] = sort_match.sort_keys.launches - before - batches
        print(json.dumps({"text_seed": s, "overflow_batches": counts[s],
                          "batches": batches,
                          "ratio": len(stream) / len(text), "s": dt}),
              flush=True)
    mean = sum(counts.values()) / len(counts)
    pick = next((s for s, c in counts.items() if c == math.ceil(mean)),
                None)
    print(json.dumps({"texts": len(counts), "mean_overflow_batches": mean,
                      "texts_with_overflow": sum(c > 0 for c in
                                                 counts.values()),
                      "first_text_seed_at_the_mean_rounded_up": pick}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
