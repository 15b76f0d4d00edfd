"""The port's KV access recording and its compilation into fabric traffic
against the JAX package: ``record_serving_run`` streams, the pool's and the
engine's recorder hooks (a model engine records what a traffic-only engine
records), ``ServingSource.emit`` rows, ``serving_scenario(...).compile()`` and
the error messages.  Integers compare exactly; there are no floats here."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.scenarios import serving as ref_serving  # noqa: E402
from repro.serving import record as ref_record  # noqa: E402
from repro.serving.pool import BankedKVPool as RefPool  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.scenarios import serving  # noqa: E402
from repro_torch.serving import record  # noqa: E402
from repro_torch.serving.pool import BankedKVPool  # noqa: E402

#: record_serving_run kwargs: its defaults, a tight pool with waiting
#: admissions, a one-slot engine, the co-sim grid's shape and the scale mode's
RUNS = {
    "defaults": {},
    "tight_pool": dict(num_requests=12, max_batch=3, max_len=40, block_size=8, prompt_lo=4,
                       prompt_hi=30, max_new_tokens=9, seed=3),
    "one_slot": dict(num_requests=5, max_batch=1, max_len=64, prompt_lo=1, prompt_hi=50,
                     max_new_tokens=4, seed=1),
    "cosim_grid": dict(num_requests=24, max_batch=4, max_len=120, prompt_lo=48, prompt_hi=96,
                       max_new_tokens=8),
    "scale_mode": dict(num_requests=256, max_batch=16, max_len=57, prompt_lo=16, prompt_hi=33,
                       max_new_tokens=8, max_steps=None),
}


def _key(rec):
    """``events_key()`` with each event as (kind, fields): the two packages'
    event classes are distinct types."""
    return tuple(
        tuple((type(e).__name__, dataclasses.astuple(e)) for e in part)
        if isinstance(part, tuple) else part
        for part in rec.events_key()
    )


@pytest.mark.parametrize("name", list(RUNS))
def test_record_serving_run_matches_reference(name):
    ours = record.record_serving_run(**RUNS[name])
    ref = ref_record.record_serving_run(**RUNS[name])
    assert _key(ours) == _key(ref)
    assert ours.summary() == ref.summary()
    assert ours.num_requests == ref.num_requests
    assert _key(record.record_serving_run(**RUNS[name])) == _key(ours)  # deterministic


def test_undrained_recording_raises_as_the_reference_does():
    kw = dict(num_requests=9, max_batch=2, max_steps=5)
    with pytest.raises(RuntimeError, match="drained only 0 of 9"):
        ref_record.record_serving_run(**kw)
    with pytest.raises(RuntimeError, match="drained only 0 of 9"):
        record.record_serving_run(**kw)


@pytest.mark.parametrize("placement", ["fractal", "sequential"])
def test_pool_hooks_match_reference(placement):
    """Seeded alloc/free churn on a small pool: successful allocations and
    non-empty frees record, failed allocations and empty frees do not."""
    ours_rec, ref_rec = record.KVAccessRecorder(), ref_record.KVAccessRecorder()
    for r in (ours_rec, ref_rec):
        r.bind_pool(32, 16, 8, 4)
    ours = BankedKVPool(32, 16, num_banks=8, placement=placement, recorder=ours_rec)
    ref = RefPool(32, 16, num_banks=8, placement=placement, recorder=ref_rec)
    rng = np.random.default_rng(4)
    live, failed = [], 0
    for step in range(200):
        ours_rec.step = ref_rec.step = step
        if live and rng.random() < 0.4:
            rid = live.pop(int(rng.integers(len(live))))
            assert ours.free(rid) == ref.free(rid)
        elif rng.random() < 0.1:
            assert ours.free(99_999) == ref.free(99_999) == 0  # nothing to free
        else:
            rid, n = 500 + step, int(rng.integers(1, 12))
            got = ours.alloc(rid, n)
            assert got == ref.alloc(rid, n)
            if got is None:
                failed += 1
            else:
                live.append(rid)
    assert failed > 0  # the churn reached an exhausted pool
    assert _key(ours_rec.record) == _key(ref_rec.record)


def test_model_engine_records_the_traffic_only_stream():
    """A smoke-size model engine on the CPU (the kernels' plain versions)
    records the stream of a traffic-only engine on the same prompts: no
    control decision reads a logit.  Prompts plus new tokens run past
    ``max_len``, so a request's allocation is wider than the engine's block
    table, and the decode events must carry the full allocation."""
    cfg = smoke(get_config("stablelm-1.6b"))
    spec = serve.ServeSpec(
        requests=6, prompt_lo=3, prompt_hi=12, max_new_tokens=8, max_batch=4, max_len=16,
        block_size=4,
    )
    prompts = serve.make_prompts(cfg, spec, seed=5)
    model = M.init_params(cfg, 0, device="cpu")
    recs = {}
    for name, args in (("model", (cfg, model)), ("traffic", (None, None))):
        recs[name] = record.KVAccessRecorder()
        eng, reqs = serve.new_engine(*args, spec, prompts, recorder=recs[name])
        eng.run()
        assert all(r.done for r in reqs)
    ref_rec = ref_record.KVAccessRecorder()
    from repro.serving.engine import ServingEngine as RefEngine

    ref = RefEngine(None, None, max_batch=4, max_len=16, block_size=4, recorder=ref_rec)
    for p in prompts:
        ref.submit(p, max_new_tokens=spec.max_new_tokens)
    ref.run()
    assert ref.steps == eng.steps
    assert _key(recs["model"].record) == _key(recs["traffic"].record) == _key(ref_rec.record)
    table_width = -(-spec.max_len // spec.block_size)
    assert any(len(e.blocks) > table_width for e in recs["model"].record.decodes)


def _records():
    kw = RUNS["tight_pool"]
    return record.record_serving_run(**kw), ref_record.record_serving_run(**kw)


@pytest.mark.parametrize("kind,index", [("decode", 0), ("decode", 2), ("prefill", 0),
                                        ("prefill", 1)])
def test_serving_source_emit_matches_reference(kind, index):
    ours, ref = _records()
    a = serving.ServingSource(ours, kind, index, cycles_per_step=96)
    b = ref_serving.ServingSource(ref, kind, index, cycles_per_step=96)
    assert a.span_beats() == b.span_beats()
    lo = 512
    kw = dict(txns=1, rate=1.0, seed=0, params={})
    got = a.emit(lo, lo + a.span_beats(), **kw)
    want = b.emit(lo, lo + b.span_beats(), **kw)
    assert len(got[0]) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize(
    "kw",
    [dict(cycles_per_step=192, decode_deadline=768), dict(num_prefill_ports=3, include_prefill=True,
                                                          beats_per_token=4),
     dict(include_prefill=False, decode_qos="safety"), dict(region=(1024, 8192))],
    ids=["grid", "three_ports", "decode_alone", "region"],
)
def test_serving_scenario_compiles_as_the_reference(kw):
    ours, ref = _records()
    a = serving.serving_scenario(ours, **kw).compile()
    b = ref_serving.serving_scenario(ref, **kw).compile()
    for col in ("is_write", "burst", "addr", "start", "prio"):
        np.testing.assert_array_equal(getattr(a.trace, col), getattr(b.trace, col))
    assert a.qos == b.qos and a.priorities == b.priorities
    assert a.share_groups == b.share_groups == [serving.KV_SHARE_GROUP] * len(a.qos)
    assert a.deadlines == b.deadlines and a.regions == b.regions
    assert a.scenario.description == b.scenario.description


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda pkg, rec: pkg.ServingSource(rec, "gather", 0), "kind"),
        (lambda pkg, rec: pkg.ServingSource(rec, "decode", 3), "out of range"),
        (lambda pkg, rec: pkg.ServingSource(rec, "prefill", 2), "out of range"),
        (
            lambda pkg, rec: pkg.ServingSource(rec, "decode", 0).emit(
                0, 100, txns=1, rate=1.0, seed=0, params={}
            ),
            "too small",
        ),
    ],
    ids=["kind", "decode_slot", "prefill_port", "region"],
)
def test_serving_errors_match_reference(make, match):
    ours, ref = _records()
    with pytest.raises(ValueError, match=match) as got:
        make(serving, ours)
    with pytest.raises(ValueError, match=match) as want:
        make(ref_serving, ref)
    assert str(got.value) == str(want.value)
