"""MMLU evaluation CLI over the FP4 serving stack.

The north-star quality bar (BASELINE.md) is the reference's own check:
MMLU on Llama-3.3-70B, FP4 drop <= 1.4 points vs BF16 (reference
README.md:3). The reference runs it through SGLang; this framework scores
it natively via models/eval.py's batched log-likelihood protocol (the
lm-eval-harness convention: argmax over log P(" A".." D" | prompt)).

Usage (offline: local checkpoint + local MMLU csv directory):
  python tools/eval_mmlu.py --model /path/to/hf_llama --data /path/to/mmlu \
      --fmt nvfp4 --few-shot 5 [--subjects abstract_algebra,...] [--limit N]

--data expects the standard MMLU layout: <data>/test/<subject>_test.csv and
<data>/dev/<subject>_dev.csv rows of (question, A, B, C, D, answer-letter).
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_mmlu_csv(path: str):
    """[(question, [4 choices], answer_idx)] from an MMLU csv."""
    rows = []
    with open(path, newline="", encoding="utf-8") as f:
        for r in csv.reader(f):
            if len(r) != 6:
                raise ValueError(f"{path}: expected 6 columns, got {len(r)}")
            rows.append((r[0], r[1:5], "ABCD".index(r[5].strip())))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True, help="HF checkpoint dir")
    ap.add_argument("--data", required=True, help="MMLU csv root dir")
    ap.add_argument("--fmt", default="nvfp4",
                    choices=["bf16", "nvfp4", "mxfp4", "hybrid"])
    ap.add_argument("--few-shot", type=int, default=5)
    ap.add_argument("--subjects", default="",
                    help="comma-separated subset (default: all)")
    ap.add_argument("--limit", type=int, default=0,
                    help="max questions per subject (0 = all)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--through-engine", action="store_true",
                    help="score through the serving Engine's forward path "
                         "(the configuration actually served) instead of "
                         "the direct eval forward")
    args = ap.parse_args()

    from transformers import AutoTokenizer
    from petit_jax.models import eval as ev, loader

    tok = AutoTokenizer.from_pretrained(args.model, local_files_only=True)
    encode = lambda s: tok.encode(s, add_special_tokens=False)
    cfg, params = loader.load_llama(args.model, fmt=args.fmt)
    if cfg.max_seq_len != args.max_seq_len:
        import dataclasses
        cfg = dataclasses.replace(cfg, max_seq_len=args.max_seq_len)
    engine = None
    if args.through_engine:
        from petit_jax.models import serving
        engine = serving.Engine(params, cfg, max_batch=args.batch,
                                fmt=args.fmt)

    test_files = sorted(glob.glob(os.path.join(args.data, "test",
                                               "*_test.csv")))
    if args.subjects:
        keep = set(args.subjects.split(","))
        test_files = [f for f in test_files
                      if os.path.basename(f)[: -len("_test.csv")] in keep]
    if not test_files:
        raise SystemExit(f"no *_test.csv under {args.data}/test")

    total_ok = total_n = 0
    per_subject = {}
    for tf in test_files:
        subject = os.path.basename(tf)[: -len("_test.csv")]
        rows = read_mmlu_csv(tf)
        if args.limit:
            rows = rows[: args.limit]
        dev = os.path.join(args.data, "dev", f"{subject}_dev.csv")
        shots = (read_mmlu_csv(dev)[: args.few_shot]
                 if args.few_shot and os.path.exists(dev) else [])
        qs = ev.mmlu_questions(rows, encode, subject=subject,
                               few_shot=shots)
        acc, _ = ev.score_multiple_choice(params, cfg, qs, fmt=args.fmt,
                                          batch=args.batch, engine=engine)
        per_subject[subject] = {"acc": acc, "n": len(qs)}
        total_ok += round(acc * len(qs))
        total_n += len(qs)
        print(f"{subject}: {acc:.4f} ({len(qs)})", file=sys.stderr)

    print(json.dumps({"metric": "mmlu_acc", "fmt": args.fmt,
                      "value": total_ok / total_n, "n": total_n,
                      "subjects": per_subject}))


if __name__ == "__main__":
    main()
