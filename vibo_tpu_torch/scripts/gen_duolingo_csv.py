"""Generate a DuoLingo-shaped learning-traces CSV (counterpart of the repo's
`scripts/gen_duolingo_csv.py`, byte for byte the same file for the same
arguments).

The real "13 million learning traces" dump is not redistributable, so this
writes a synthetic file with the schema the duolingo loader reads (user_id,
lexeme_id, session_correct, session_seen), responses drawn from a 2PL model
so the ingested matrix is learnable. numpy only: the seed stream, the
chunking and the np.char row formatting are the reference script's.

  python -m vibo_tpu_torch.scripts.gen_duolingo_csv build/duo/duolingo.csv \\
      --rows 13000000 --users 140000 --lexemes 2048
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def generate(path: str, rows: int, users: int, lexemes: int, seed: int = 0,
             chunk: int = 1_000_000) -> None:
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=users).astype(np.float32)
    a = np.abs(rng.normal(1.0, 0.3, size=lexemes)).astype(np.float32)
    b = rng.normal(size=lexemes).astype(np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", buffering=1 << 22) as f:
        f.write("user_id,lexeme_id,session_correct,session_seen\n")
        written = 0
        while written < rows:
            n = min(chunk, rows - written)
            u = rng.integers(0, users, size=n)
            j = rng.integers(0, lexemes, size=n)
            logits = a[j] * theta[u] - b[j]
            p = 1.0 / (1.0 + np.exp(-logits))
            seen = rng.integers(1, 5, size=n)
            correct = rng.binomial(seen, p)
            # vectorized row formatting: one join per chunk
            lines = np.char.add(
                np.char.add(
                    np.char.add(np.char.add("u", u.astype("U7")), ","),
                    np.char.add(np.char.add("lex:", j.astype("U5")), ",")),
                np.char.add(np.char.add(correct.astype("U2"), ","),
                            seen.astype("U2")))
            f.write("\n".join(lines.tolist()))
            f.write("\n")
            written += n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path")
    ap.add_argument("--rows", type=int, default=13_000_000)
    ap.add_argument("--users", type=int, default=140_000)
    ap.add_argument("--lexemes", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    generate(args.path, args.rows, args.users, args.lexemes, args.seed)
    size_mb = os.path.getsize(args.path) / 1e6
    print(f"wrote {args.rows} rows ({size_mb:.0f} MB) to {args.path} "
          f"in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
