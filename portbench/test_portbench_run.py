"""Whole runs on the CPU, at reduced sizes, of throwaway cells made of
data files only (``pbcore.tiny``): the harness's look for a card is
skipped, everything else of a run is driven. A sound run is correct; a
timed path broken underneath is not, once for each fault a serving cell
can have; the control (the reference one step below the stated
precision) is not."""
import time

import pytest

torch = pytest.importorskip("torch")

from pbcore import harness, tiny  # noqa: E402


def _run(tmp_path, seed=3, seconds=2.0, hooks=None, control=False,
         chunk=0, cfg=None, **wl):
    cfg = cfg or tiny.config()
    w = tiny.workload("t-cfg", "t-mix", chunk=chunk, **wl)
    bench = tiny.bench(tmp_path, "t.cell", cfg, w)
    cell = bench.cell("t.cell")
    return harness.run_cell(bench, cell, seed, seconds, False, "cpu",
                            time.perf_counter(), hooks=hooks,
                            control=control)


@pytest.mark.parametrize("chunk", [0, 24])
def test_a_data_only_cell_runs_correct(tmp_path, chunk):
    out = _run(tmp_path, chunk=chunk)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == 16
    assert set(out["metrics"]) == {"ttft_p50_s", "atgt_p90_ms",
                                   "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert out["checks"]["tokens_compared"]["value"] >= 64
    assert out["device"]["platform"] == "cpu"


def _each_engine(fn):
    def hook(cluster):
        for w in cluster.workers.values():
            fn(w.engine)
    return hook


def _alter_token(eng):
    orig = eng._decode

    def decode(tokens, active):
        logits = orig(tokens, active)
        top = logits.argmax(dim=-1)
        logits[active[0], (top[active[0]] + 1) % logits.shape[1]] = \
            logits.max() + 1.0
        return logits
    eng._decode = decode


def _half_batch(eng):
    """Half of the live rows left out: they get the mean of the others'
    logits."""
    orig = eng._decode

    def decode(tokens, active):
        logits = orig(tokens, active)
        keep, drop = active[:(len(active) + 1) // 2], \
            active[(len(active) + 1) // 2:]
        if drop:
            logits[drop] = logits[keep].mean(dim=0)
        return logits
    eng._decode = decode


def _state_unchanged(eng):
    eng._write_kv = lambda slot, start, ks, vs: None


def _stall(eng):
    eng.step = lambda now=None: []


@pytest.mark.parametrize("fault,chunk", [
    (_alter_token, 0), (_half_batch, 0), (_state_unchanged, 0),
    (_state_unchanged, 24), (_stall, 0)])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault, chunk):
    out = _run(tmp_path, hooks={"cluster": _each_engine(fault)},
               chunk=chunk, drain_s=3.0)
    assert out["correct"] is False
    c = out["checks"]
    assert any(c[k]["value"] > c[k]["limit"] for k in
               ("max_logit_gap", "max_logit_err", "failed", "wrong_length"))


SMALL = dict(layers=2, d=128, hq=4, hkv=2, hd=32, ff=256, vocab=1024)


@pytest.mark.parametrize("dtype,chunk,limits", [
    ("bfloat16", 0, (0.008, 0.2)), ("float32", 24, (1e-6, 5e-4))])
def test_the_control_is_not_correct(tmp_path, dtype, chunk, limits):
    """The control (the reference one step below the stated precision)
    put in the program's place comes out not correct; the program, at the
    same limits, correct. bf16 one-shot prefill against fp8: at this size
    the program read gap 4e-4 - 1.7e-3, error 0.034 - 0.055, the control
    gap 0.023 - 0.040, error 0.58 - 0.60; all-fp32 chunked against tf32:
    the program gap 0, error 3.6e-6 - 3.8e-6, the control gap 0 - 1e-4,
    error 5.4e-3 - 5.8e-3. The card suite, ``test_portbench_card.py``,
    runs both at the cells' sizes."""
    for seed in (0, 1):
        out = _run(tmp_path / str(seed), seed=seed, seconds=3.0,
                   control=True, chunk=chunk,
                   cfg=tiny.config(**SMALL, dtype=dtype), served_tokens=400,
                   limit=limits[0], err_limit=limits[1])
        assert out["correct"] is False, out["checks"]
        assert out["checks"]["max_logit_err"]["value"] > limits[1]
        assert out["program"]["max_logit_gap"] <= limits[0]
        assert out["program"]["max_logit_err"] <= limits[1]


def test_the_tap_holds_the_logits_each_served_token_came_from(tmp_path):
    """The program's top logits at every served position of every
    finished request, in order: the first of each is the served token."""
    from pbcore import check, serve
    bench = tiny.bench(tmp_path, "t.cell", tiny.config(),
                       tiny.workload("t-cfg", "t-mix", chunk=24))
    cell = bench.cell("t.cell")
    cfg = cell.config
    weights = serve.make_weights(cfg, 5, "cpu")
    cluster = harness.build_cluster(cell, serve.port_arch(cfg), weights,
                                    "cpu")
    obs = serve.Observer(cluster, time.perf_counter)
    tap = check.LogitTap(cluster)
    arrivals = bench.generator("open_loop").generate(
        cell.traffic, 5, 1.0, cfg["vocab_size"])
    served = serve.serve(cluster, obs, arrivals, 1.0, drain_s=60.0)
    done = [r for r, _, _ in served.requests]
    assert done and all(r.id in obs.finish for r in done)
    rows = tap.rows(done)
    for r in done:
        values, ids = rows[r.id]
        assert ids.shape == (r.l_real, check.TOP)
        assert list(ids[:, 0]) == r.tokens[r.l_in:]
        assert (values[:, :-1] >= values[:, 1:]).all()
    tap.detach()
    assert all("_decode" not in w.engine.__dict__
               for w in cluster.workers.values())
