"""Eval harness: log-likelihood scoring, MMLU formatting/tokenizing,
multiple-choice accuracy, perplexity, FP4-vs-BF16 delta (the north-star
MMLU protocol at test scale — BASELINE.md quality bar)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from petit_jax.models import llama
from petit_jax.models import eval as ev


@pytest.fixture(scope="module")
def setup():
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


def _manual_ll(params, cfg, ctx, cont):
    ids = jnp.asarray(list(ctx) + list(cont), jnp.int32)[None]
    logits, _ = llama.forward(params, ids[:, :-1], cfg)
    logp = jax.nn.log_softmax(np.asarray(logits, np.float32), -1)[0]
    tot = 0.0
    for t in range(len(ctx), len(ctx) + len(cont)):
        tot += float(logp[t - 1, int(ids[0, t])])
    return tot


def test_loglikelihood_matches_manual(setup):
    cfg, params = setup
    pairs = [([5, 9, 42], [7, 11]), ([1, 2], [3]), ([100], [3, 4, 5, 6])]
    got = ev.loglikelihood(params, cfg, pairs)
    want = [_manual_ll(params, cfg, c, x) for c, x in pairs]
    # bf16 forward jitter across padded shapes: ~1e-2 absolute
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)


def test_loglikelihood_bucketing_invariant(setup):
    """Scores must not depend on which batch/bucket a row lands in: a short
    row padded next to a long one == the same row scored alone."""
    cfg, params = setup
    short, long_ = ([5, 9], [42]), (list(range(40)), [7, 11, 13])
    alone = ev.loglikelihood(params, cfg, [short], batch=1)
    mixed = ev.loglikelihood(params, cfg, [long_, short, short], batch=2)
    np.testing.assert_allclose(mixed[1:], [alone[0]] * 2, rtol=2e-3,
                               atol=2e-2)


def test_multiple_choice_self_consistent(setup):
    """score_multiple_choice picks exactly the choice with the highest
    manual log-likelihood; labeling those picks as answers gives acc=1."""
    cfg, params = setup
    rng = np.random.default_rng(0)
    qs = []
    for _ in range(4):
        ctx = list(rng.integers(0, cfg.vocab_size, 5))
        choices = [list(rng.integers(0, cfg.vocab_size, rng.integers(1, 4)))
                   for _ in range(4)]
        qs.append({"context": ctx, "choices": choices, "answer": 0})
    # label each question with the harness's own preference (deterministic:
    # score_multiple_choice recomputes the identical batched program)
    for q in qs:
        lls = ev.loglikelihood(params, cfg,
                               [(q["context"], c) for c in q["choices"]])
        q["answer"] = int(np.argmax(lls))
    acc, picks = ev.score_multiple_choice(params, cfg, qs)
    assert acc == 1.0
    assert picks == [q["answer"] for q in qs]


def test_perplexity(setup):
    cfg, params = setup
    ids = [5, 9, 42, 7, 11, 13, 2, 3]
    ppl = ev.perplexity(params, cfg, ids)
    want = np.exp(-_manual_ll(params, cfg, ids[:1], ids[1:]) / (len(ids) - 1))
    assert np.isfinite(ppl)
    np.testing.assert_allclose(ppl, want, rtol=1e-2)


def test_format_mmlu_protocol():
    ctx, conts = ev.format_mmlu(
        "What is 2+2?", ["3", "4", "5", "22"], subject="abstract_algebra",
        few_shot=[("What is 1+1?", ["1", "2", "0", "11"], 1)])
    assert ctx.startswith("The following are multiple choice questions")
    assert "abstract algebra" in ctx
    assert "What is 1+1?" in ctx and "Answer: B\n" in ctx  # few-shot solved
    assert ctx.endswith("Answer:") and "D. 22" in ctx
    assert conts == [" A", " B", " C", " D"]


def test_mmlu_questions_tokenize_and_score(setup):
    """End-to-end MMLU protocol with a stub char-level tokenizer."""
    cfg, params = setup
    encode = lambda s: [ord(c) % cfg.vocab_size for c in s]
    rows = [("What is 2+2?", ["3", "4", "5", "22"], 1),
            ("Pick A.", ["yes", "no"], 0)]
    qs = ev.mmlu_questions(rows, encode, subject="tests")
    assert [q["answer"] for q in qs] == [1, 0]
    assert all(len(c) == 2 for c in qs[0]["choices"])  # " A" -> 2 chars
    acc, picks = ev.score_multiple_choice(params, cfg, qs)
    assert 0.0 <= acc <= 1.0 and len(picks) == 2


def test_fp4_accuracy_delta(setup):
    cfg, params = setup
    rng = np.random.default_rng(1)
    qs = [{"context": list(rng.integers(0, cfg.vocab_size, 4)),
           "choices": [list(rng.integers(0, cfg.vocab_size, 2))
                       for _ in range(4)],
           "answer": 0} for _ in range(3)]
    out = ev.fp4_accuracy_delta(params, cfg, qs, fmt="nvfp4",
                                interpret=True)
    assert set(out) == {"bf16", "nvfp4", "delta"}
    assert abs(out["delta"]) <= 1.0


def test_mmlu_csv_reader(tmp_path):
    import importlib.util, os
    spec = importlib.util.spec_from_file_location(
        "eval_mmlu", os.path.join(os.path.dirname(__file__), "..",
                                  "tools", "eval_mmlu.py"))
    em = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(em)
    p = tmp_path / "x_test.csv"
    p.write_text('What is 2+2?,3,4,5,22,B\n"A, tricky one?",w,x,y,z,D\n')
    rows = em.read_mmlu_csv(str(p))
    assert rows == [("What is 2+2?", ["3", "4", "5", "22"], 1),
                    ("A, tricky one?", ["w", "x", "y", "z"], 3)]


def test_loglikelihood_through_engine(setup):
    """engine= path: scoring through the serving engines' forward matches
    the direct eval path (same model/format)."""
    from petit_jax.models import serving
    cfg, params = setup
    pairs = [([1, 2, 3], [7, 8]), ([4, 5], [6]), ([9], [10, 11, 12])]
    want = ev.loglikelihood(params, cfg, pairs, fmt="bf16")
    eng = serving.Engine(params, cfg, max_batch=4)
    got = ev.loglikelihood(None, None, pairs, engine=eng)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    peng = serving.PagedEngine(params, cfg, max_batch=4, page_size=16)
    gotp = ev.loglikelihood(None, None, pairs, engine=peng)
    np.testing.assert_allclose(gotp, want, rtol=1e-3, atol=1e-3)


def test_multiple_choice_through_engine(setup):
    from petit_jax.models import serving
    cfg, params = setup
    rng = np.random.default_rng(0)
    qs = [{"context": list(rng.integers(1, 50, size=5)),
           "choices": [[int(c)] for c in rng.integers(1, 50, size=4)],
           "answer": int(rng.integers(0, 4))} for _ in range(6)]
    acc_direct, picks_direct = ev.score_multiple_choice(
        params, cfg, qs, fmt="bf16")
    eng = serving.Engine(params, cfg, max_batch=4)
    acc_eng, picks_eng = ev.score_multiple_choice(
        None, None, qs, engine=eng)
    assert picks_eng == picks_direct and acc_eng == acc_direct


def test_fp4_quality_gate_trained_model():
    """The BASELINE quality gate on a TRAINED model (not random init): a
    2-layer Llama trained to ~100% on associative recall must keep its
    accuracy through NVFP4 quantization (the round-1 harness only pinned
    the protocol on random models, where the delta measures nothing)."""
    import importlib.util, os
    spec = importlib.util.spec_from_file_location(
        "quality_gate", os.path.join(os.path.dirname(__file__), "..",
                                     "tools", "quality_gate.py"))
    qg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qg)
    from petit_jax.models import llama
    # round-4 gate semantics: training EARLY-STOPS once held-out accuracy
    # crosses target_acc (the gate wants thin margins, not saturation) —
    # ask for a modest target so the test stays fast and deterministic
    cfg, params, train_acc = qg.train(steps=1200, target_acc=0.9)
    assert train_acc >= 0.88, train_acc
    qs = qg.questions(np.random.default_rng(7), 60)
    acc_bf16, _ = ev.score_multiple_choice(params, cfg, qs, fmt="bf16")
    qp = llama.quantize_params(params, "nvfp4")
    acc_fp4, _ = ev.score_multiple_choice(qp, cfg, qs, fmt="nvfp4",
                                          interpret=True)
    assert acc_bf16 >= 0.9, acc_bf16
    # the reference's bar is a <=1.4-point drop at 70B; at this scale we
    # allow 5 points of headroom on 60 questions
    assert acc_bf16 - acc_fp4 <= 0.05, (acc_bf16, acc_fp4)
