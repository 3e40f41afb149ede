"""Quality evaluation: log-likelihood scoring, multiple-choice accuracy
(MMLU-style), perplexity, and a BF16-vs-FP4 accuracy-delta harness.

The reference validates its FP4 path with MMLU on Llama-3.3-70B served by
SGLang (reference README.md:3: BF16 82.15 vs NVFP4 80.79); the north star
keeps that bar (BASELINE.md: MMLU drop <= 1.4). The reference repo itself
has no eval code — the serving framework runs it — so for a standalone
framework this is new-build territory: a lm-eval-style log-likelihood
scorer over our own forward pass.

Notes:
  - Scoring is one batched forward per length bucket (pad to a multiple of
    `bucket`, group rows by padded length) so the jit cache holds a handful
    of programs instead of one per example length.
  - Continuation log-probs are summed with a position mask — no ragged
    shapes, no host loop over tokens.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import llama


def _pad_to(x: np.ndarray, L: int) -> np.ndarray:
    out = np.zeros(L, np.int32)
    out[: len(x)] = x
    return out


@functools.partial(jax.jit, static_argnames=("cfg", "fmt", "interpret"))
def _score_batch(params, toks, cont_mask, cfg, fmt, interpret):
    """Sum of log P(tok[t] | tok[:t]) over positions where cont_mask[t]=1.

    toks (B, L) int32, cont_mask (B, L) f32. Position t's probability comes
    from the logits at t-1, so the first row position is never scored
    (a continuation always has a non-empty context in front of it).
    """
    logits, _ = llama.forward(params, toks[:, :-1], cfg, fmt=fmt,
                              interpret=interpret)
    return _sum_cont_logprobs(logits, toks, cont_mask)


@jax.jit
def _sum_cont_logprobs(logits, toks, cont_mask):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    tgt = toks[:, 1:]
    tok_lp = jnp.take_along_axis(logp, tgt[..., None], -1)[..., 0]
    return (tok_lp * cont_mask[:, 1:]).sum(-1)


def loglikelihood(params, cfg: llama.LlamaConfig,
                  pairs: Sequence[tuple[Sequence[int], Sequence[int]]], *,
                  fmt: str = "bf16", interpret: bool = False,
                  bucket: int = 32, batch: int = 8,
                  engine=None) -> np.ndarray:
    """log P(continuation | context) for each (context, continuation) pair
    of token-id sequences. Returns (len(pairs),) float64.

    engine: a serving.Engine/PagedEngine — scoring then runs THROUGH the
    engine's forward path (its jitted graphs, cache dtype, TP sharding),
    so the quality number measures the configuration actually served
    rather than a parallel eval-only code path; params/cfg/fmt arguments
    are ignored in favor of the engine's own."""
    rows, masks, lens = [], [], []
    for ctx, cont in pairs:
        assert len(ctx) >= 1, "continuation needs a non-empty context"
        ids = np.asarray(list(ctx) + list(cont), np.int32)
        m = np.zeros(len(ids), np.float32)
        m[len(ctx):] = 1.0
        rows.append(ids)
        masks.append(m)
        lens.append(len(ids))
    if engine is not None:
        cfg = engine.cfg
        batch = engine.B          # scratch cache is cloned at max_batch
    out = np.zeros(len(pairs), np.float64)
    # group by padded length, then score in fixed-size batches
    order = np.argsort(lens, kind="stable")
    for start in range(0, len(order), batch):
        idx = order[start: start + batch]
        L = -(-max(lens[i] for i in idx) // bucket) * bucket
        L = min(L, cfg.max_seq_len)
        assert max(lens[i] for i in idx) <= cfg.max_seq_len, "row too long"
        toks = np.stack([_pad_to(rows[i], L) for i in idx])
        cm = np.stack([_pad_to_f(masks[i], L) for i in idx])
        # pad the batch dim too, so the jit cache is keyed only by L
        pad_b = batch - len(idx)
        if pad_b:
            toks = np.concatenate([toks, np.zeros((pad_b, L), np.int32)])
            cm = np.concatenate([cm, np.zeros((pad_b, L), np.float32)])
        if engine is not None:
            logits = engine.score_forward(jnp.asarray(toks[:, :-1]))
            scores = _sum_cont_logprobs(logits, jnp.asarray(toks),
                                        jnp.asarray(cm))
        else:
            scores = _score_batch(params, jnp.asarray(toks),
                                  jnp.asarray(cm), cfg, fmt, interpret)
        out[idx] = np.asarray(scores, np.float64)[: len(idx)]
    return out


def _pad_to_f(x: np.ndarray, L: int) -> np.ndarray:
    out = np.zeros(L, np.float32)
    out[: len(x)] = x
    return out


def perplexity(params, cfg: llama.LlamaConfig, tokens: Sequence[int], *,
               fmt: str = "bf16", interpret: bool = False) -> float:
    """exp(mean NLL) of tokens[1:] given tokens[:1] rolling context."""
    ids = list(tokens)
    (ll,) = loglikelihood(params, cfg, [(ids[:1], ids[1:])], fmt=fmt,
                          interpret=interpret, batch=1)
    return float(np.exp(-ll / (len(ids) - 1)))


# -- multiple choice -----------------------------------------------------------


def score_multiple_choice(params, cfg: llama.LlamaConfig,
                          questions: Sequence[dict], *, fmt: str = "bf16",
                          interpret: bool = False, batch: int = 8,
                          engine=None):
    """Each question: {"context": [ids], "choices": [[ids], ...],
    "answer": int}. Picks argmax_choice log P(choice | context) (the
    lm-eval-harness MMLU protocol). Returns (accuracy, picks).
    engine: score through a serving engine (see loglikelihood)."""
    pairs, spans = [], []
    for q in questions:
        spans.append((len(pairs), len(q["choices"])))
        pairs.extend((q["context"], ch) for ch in q["choices"])
    lls = loglikelihood(params, cfg, pairs, fmt=fmt, interpret=interpret,
                        batch=batch, engine=engine)
    picks = [int(np.argmax(lls[s: s + n])) for s, n in spans]
    correct = sum(p == q["answer"] for p, q in zip(picks, questions))
    return correct / len(questions), picks


MMLU_PREAMBLE = ("The following are multiple choice questions (with "
                 "answers) about {subject}.\n\n")
_LETTERS = "ABCD"


def format_mmlu(question: str, choices: Sequence[str], *,
                subject: str = "miscellaneous",
                few_shot: Sequence[tuple[str, Sequence[str], int]] = ()):
    """(context_text, choice_texts) in the standard MMLU prompt format;
    the choice text scored is ' A'/' B'/... after 'Answer:'."""
    ctx = MMLU_PREAMBLE.format(subject=subject.replace("_", " "))
    for fq, fch, fans in few_shot:
        ctx += _one_question(fq, fch) + f" {_LETTERS[fans]}\n\n"
    ctx += _one_question(question, choices)
    return ctx, [f" {_LETTERS[i]}" for i in range(len(choices))]


def _one_question(q: str, choices: Sequence[str]) -> str:
    lines = [q.strip()]
    lines += [f"{_LETTERS[i]}. {c}" for i, c in enumerate(choices)]
    lines.append("Answer:")
    return "\n".join(lines)


def mmlu_questions(rows: Sequence[tuple[str, Sequence[str], int]],
                   encode: Callable[[str], list[int]], *,
                   subject: str = "miscellaneous",
                   few_shot: Sequence[tuple[str, Sequence[str], int]] = ()):
    """Tokenize MMLU rows (question, choices, answer_idx) into
    score_multiple_choice inputs. `encode` is any text->ids callable (e.g.
    transformers tokenizer.encode); continuations are tokenized as the
    suffix of context+choice so BPE merges across the boundary are exact."""
    out = []
    for q, choices, ans in rows:
        ctx_text, choice_texts = format_mmlu(q, choices, subject=subject,
                                             few_shot=few_shot)
        ctx_ids = encode(ctx_text)
        conts = []
        for ct in choice_texts:
            full = encode(ctx_text + ct)
            assert full[: len(ctx_ids)] == ctx_ids, \
                "tokenizer merged across the context boundary"
            conts.append(full[len(ctx_ids):])
        out.append({"context": ctx_ids, "choices": conts, "answer": ans})
    return out


def fp4_accuracy_delta(params, cfg: llama.LlamaConfig,
                       questions: Sequence[dict], *, fmt: str = "nvfp4",
                       interpret: bool = False, **quant_kw):
    """The north-star quality check at any scale: accuracy of the dense
    BF16 model vs its FP4-quantized self on the same questions
    (BASELINE.md: drop must stay <= 1.4 points at 70B)."""
    acc_bf16, _ = score_multiple_choice(params, cfg, questions, fmt="bf16",
                                        interpret=interpret)
    qparams = llama.quantize_params(params, fmt, **quant_kw)
    acc_fp4, _ = score_multiple_choice(qparams, cfg, questions, fmt=fmt,
                                       interpret=interpret)
    return {"bf16": acc_bf16, fmt: acc_fp4, "delta": acc_bf16 - acc_fp4}
