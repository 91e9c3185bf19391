"""The port's recorder (utils/trace.py): off by default, the spans of an
encrypt and a CRT decrypt on the ``"rns"`` backend with their parents and
call ids, the profiler's chrome trace, the ``PAILLIER_TORCH_PERF`` exporter,
the counters and the bounded buffer.  On the CPU (the kernels' plain
versions), a 256-bit key; no timing is asserted."""

import json
import sys
import threading

import pytest
torch = pytest.importorskip("torch")

from pailliercryptolib_tpu_torch.models.engine import PrivateEngine, PublicEngine
from pailliercryptolib_tpu_torch.models.keys import PrivateKey
from pailliercryptolib_tpu_torch.utils import config, trace
from pailliercryptolib_tpu_torch.utils.rng import DeviceSeed

#: Two 128-bit primes, both 3 mod 4: a 256-bit key
P = 0xC334629E968C80B9534AAD5888183613
Q = 0xFC75DEAE1C1D86C891FC7F590E851FFB
N = P * Q
ROWS = 3
PLAIN = [1, 2**63 + 5, 12345][:ROWS]
SEED = list(range(11))


@pytest.fixture(scope="module")
def engines():
    torch.set_num_threads(1)
    n2 = N * N
    hs = pow((-(0x1234567 ** 2)) % n2, N, n2)
    djn = PublicEngine(N, N.bit_length(), hs, 128, backend="rns", device="cpu")
    normal = PublicEngine(N, N.bit_length(), None, 0, backend="rns", device="cpu")
    sk = PrivateKey(N, P, Q, device="cpu")
    priv = PrivateEngine(sk.n, sk.p, sk.q, sk.lam, sk.x, sk.hp, sk.hq,
                         backend="rns", device="cpu")
    cts = normal.encrypt_normal(PLAIN, DeviceSeed(SEED))
    djn.fb_mask, priv.rns_crt  # the constants a first call builds lazily
    return {"djn": djn, "normal": normal, "priv": priv, "cts": cts}


@pytest.fixture(autouse=True)
def clean_recorder():
    trace.drain()
    yield
    trace.drain()


def _submit(engines, op):
    if op == "djn":
        return engines["djn"].encrypt_djn_dev(PLAIN, DeviceSeed(SEED))
    if op == "normal":
        return engines["normal"].encrypt_normal_dev(PLAIN, DeviceSeed(SEED))
    return engines["priv"].decrypt_crt_dev(engines["cts"])


#: Per op, the children of ``api.submit`` and the spans nested under them
SUBMIT_CHILDREN = {
    "djn": {"api.codec_in", "api.upload", "pipelines.chacha20", "kernels.k2",
            "pipelines.post"},
    "normal": {"api.codec_in", "api.upload", "pipelines.chacha20", "kernels.k5",
               "pipelines.post"},
    "decrypt": {"api.codec_in", "api.upload", "kernels.k3", "pipelines.crt_tail"},
}
NESTED = {
    "djn": {("pipelines.post", "pipelines.finalize")},
    "normal": {("pipelines.post", "pipelines.finalize")},
    "decrypt": {("pipelines.crt_tail", "pipelines.finalize"),
                ("pipelines.crt_tail", "kernels.k4")},
}
#: ``api.wait`` only where the batch lies on a CUDA device
FETCH_CHILDREN = {"api.pack_out", "api.download", "api.codec_out"}


def _by_id(spans):
    return {s.id: s for s in spans}


def test_off_by_default(engines):
    assert not config.get_config().perf
    assert trace.span("api.submit", trace.NEW, rows=1) is trace.OFF
    with trace.span("x") as sp:
        assert sp is trace.OFF and sp.call == 0
    trace.count("engine.constants_built")
    for op in ("djn", "normal", "decrypt"):
        out = _submit(engines, op)
        assert out.call == 0
        out.fetch()
    rec = trace.snapshot()
    assert rec["spans"] == [] and rec["dropped"] == 0
    assert not any(k.startswith(("engine.", "api.")) for k in rec["counters"])


@pytest.mark.parametrize("op", ["djn", "normal", "decrypt"])
def test_spans_and_parents(engines, op):
    with trace.recording():
        _submit(engines, op).fetch()
    spans = trace.drain()["spans"]
    by = _by_id(spans)
    roots = [s for s in spans if s.parent == 0]
    assert [s.name for s in roots] == ["api.submit", "api.fetch"]
    submit, fetch = roots
    assert submit.attrs["rows"] == ROWS and fetch.attrs == {"rows": ROWS}
    assert submit.attrs["op"] == {"djn": "encrypt_djn", "normal": "encrypt_normal",
                                  "decrypt": "decrypt_crt"}[op]
    assert {s.name for s in spans if s.parent == submit.id} == SUBMIT_CHILDREN[op]
    assert {s.name for s in spans if s.parent == fetch.id} == FETCH_CHILDREN
    pairs = {(by[s.parent].name, s.name) for s in spans
             if s.parent not in (0, submit.id, fetch.id)}
    assert pairs == NESTED[op]
    for s in spans:  # children lie inside their parents
        assert s.start_ns <= s.end_ns
        if s.parent:
            up = by[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns


def test_set_up_spans_and_counters():
    n2 = N * N
    hs = pow((-(0x7654321 ** 2)) % n2, N, n2)
    with trace.recording():
        sk = PrivateKey(N, P, Q, device="cpu")
        priv = PrivateEngine(sk.n, sk.p, sk.q, sk.lam, sk.x, sk.hp, sk.hq,
                             backend="rns", device="cpu")
        priv.rns_crt
        pub = PublicEngine(N, N.bit_length(), hs, 128, backend="rns", device="cpu")
        pub.fixedbase
    rec = trace.drain()
    by = _by_id(rec["spans"])
    outer = [s.name for s in rec["spans"] if s.parent == 0]
    assert outer == ["keys.private_key", "engine.crt_consts", "engine.fb_table"]
    inner = {(by[s.parent].name, s.name) for s in rec["spans"] if s.parent}
    assert ("engine.crt_consts", "engine.rns_context") in inner
    assert ("engine.fb_table", "engine.rns") in inner
    assert ("engine.fb_table", "kernels.k1") in inner
    # rns_crt, its context pair and their conversion constants; rns, fixedbase
    assert rec["counters"]["engine.constants_built"] == 5
    fb = [s for s in rec["spans"] if s.name == "engine.fb_table"][0]
    assert pub.fb_build_seconds == (fb.end_ns - fb.start_ns) * 1e-9


def test_timed_spans_read_the_clock_while_off():
    n2 = N * N
    pub = PublicEngine(N, N.bit_length(), pow(3, N, n2), 128, backend="rns", device="cpu")
    assert pub.fb_build_seconds == 0.0
    pub.fixedbase
    assert pub.fb_build_seconds > 0.0
    assert trace.snapshot()["spans"] == []


def test_fetch_shares_the_call_id_of_its_submit(engines):
    with trace.recording():
        a = _submit(engines, "normal")
        b = _submit(engines, "decrypt")
        assert a.call and b.call and a.call != b.call
        b.fetch()
        a.fetch()
    spans = trace.drain()["spans"]
    by = _by_id(spans)
    for out in (a, b):
        mine = [s for s in spans if s.call == out.call]
        roots = sorted(s.name for s in mine if s.parent == 0)
        assert roots == ["api.fetch", "api.submit"]
        for s in mine:
            while s.parent:
                s = by[s.parent]
            assert s.call == out.call


def test_nested_api_spans_keep_the_outer_call_id():
    with trace.recording():
        with trace.span("api.submit", trace.NEW) as outer:
            with trace.span("api.submit", trace.NEW) as inner:
                pass
        with trace.span("api.submit", trace.NEW) as other:
            pass
        with trace.span("kernels.k5") as loose:
            pass
    assert inner.call == outer.call != other.call
    assert loose.call == 0


@pytest.mark.parametrize("op", ["djn", "normal", "decrypt"])
def test_outputs_bit_equal_recording_on_and_off(engines, op):
    off = _submit(engines, op).fetch()
    with trace.recording():
        on = _submit(engines, op).fetch()
    assert on == off
    if op == "decrypt":
        assert on == PLAIN


def test_spans_land_in_the_profilers_chrome_trace(engines, tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    with trace.recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            _submit(engines, "normal").fetch()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    outer = [e for e in ann if e["name"] == "outer"][0]
    mine = [e for e in ann if e["name"] != "outer"]
    names = {e["name"] for e in mine}
    assert {"api.submit", "api.codec_in", "pipelines.chacha20", "kernels.k5",
            "pipelines.post", "api.fetch", "api.codec_out"} <= names
    for e in mine:
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    # the same spans, and only they, went to the recorder
    assert sorted(s.name for s in trace.drain()["spans"]) == sorted(e["name"] for e in mine)


def test_no_annotations_while_off(engines, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _submit(engines, "decrypt").fetch()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert not [e for e in events if e.get("cat") == "user_annotation"]


def test_perf_env_exports_host_spans(engines, monkeypatch, capsys):
    old = config.get_config()
    monkeypatch.setenv("PAILLIER_TORCH_PERF", "1")
    try:
        config.set_config(config.Config.from_env())
        assert trace.span("x") is not trace.OFF
        _submit(engines, "normal").fetch()
        _submit(engines, "decrypt").fetch()
        with config.perf_timer("legacy[B=2]"):
            pass
    finally:
        config.set_config(old)
    out = capsys.readouterr().out
    assert f"[paillier-torch perf] host api.submit[B={ROWS} op=encrypt_normal]: " in out
    assert f"[paillier-torch perf] host api.submit[B={ROWS} op=decrypt_crt]: " in out
    assert out.count(f"[paillier-torch perf] host api.fetch[B={ROWS}]: ") == 2
    assert "[paillier-torch perf] host legacy[B=2]: " in out
    # outermost spans only
    assert "api.codec_in" not in out and "kernels.k5" not in out
    assert trace.span("x") is trace.OFF


def test_perf_timer_silent_by_default(capsys):
    with config.perf_timer("quiet"):
        pass
    assert "[paillier-torch perf]" not in capsys.readouterr().out


@pytest.mark.parametrize("op", ["djn", "normal", "decrypt"])
def test_a_second_batch_builds_nothing(engines, op):
    with trace.recording():
        _submit(engines, op).fetch()  # whatever is built lazily, once
        trace.drain()
        _submit(engines, op).fetch()
    counters = trace.drain()["counters"]
    for name in ("kernels.builds", "engine.constants_built", "kernels.packs_built"):
        assert counters.get(name, 0) == 0, name


def test_counters():
    trace.count("a")
    with trace.recording():
        trace.count("a")
        trace.count("a", 4)
    rec = trace.drain()
    assert rec["counters"]["a"] == 5
    assert "kernels.launches.rns_modexp2" in rec["counters"]
    assert "kernels.launches.mod_mul" in rec["counters"]
    assert "kernels.modexp2_forms.shared" in rec["counters"]
    assert "a" not in trace.snapshot()["counters"]


def test_buffer_drops_at_its_bound_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 5)
    with trace.recording():
        for k in range(8):
            with trace.span(f"s{k}"):
                pass
    rec = trace.snapshot()
    assert [s.name for s in rec["spans"]] == [f"s{k}" for k in range(5)]
    assert rec["dropped"] == 3
    trace.drain()
    assert trace.snapshot()["dropped"] == 0 and trace.snapshot()["spans"] == []


def test_threads_record_their_own_stacks():
    """More threads than cores, a short switch interval: no span is lost and
    every span's parent is its own thread's."""
    threads, each = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for _ in range(each):
            with trace.span(f"t{k}"):
                with trace.span(f"t{k}.child"):
                    pass

    try:
        with trace.recording():
            ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    spans = trace.drain()["spans"]
    by = _by_id(spans)
    assert len(spans) == 2 * threads * each
    for s in spans:
        if s.name.endswith(".child"):
            assert by[s.parent].name == s.name[: -len(".child")]
        else:
            assert s.parent == 0


@pytest.mark.cuda
def test_spans_on_the_card(tmp_path):
    """On the card: ``api.wait`` apart from the download, the outputs equal
    with recording on and off, and the spans in the profiler's trace beside
    the kernels and the runtime calls that launch them."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    normal = PublicEngine(N, N.bit_length(), None, 0, backend="rns", device=dev)
    sk = PrivateKey(N, P, Q, device=dev)
    priv = PrivateEngine(sk.n, sk.p, sk.q, sk.lam, sk.x, sk.hp, sk.hq,
                         backend="rns", device=dev)
    want = normal.encrypt_normal(PLAIN, DeviceSeed(SEED))
    assert priv.decrypt_crt(want) == PLAIN
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with trace.recording(), profile(activities=acts) as prof:
        got = normal.encrypt_normal_dev(PLAIN, DeviceSeed(SEED)).fetch()
        assert priv.decrypt_crt_dev(got).fetch() == PLAIN
    assert got == want
    spans = trace.drain()["spans"]
    by = _by_id(spans)
    fetch_kids = [s.name for s in spans if s.parent and by[s.parent].name == "api.fetch"]
    assert fetch_kids.count("api.wait") == 2
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"api.submit", "kernels.k5", "kernels.k3", "api.wait", "api.codec_out"} <= set(ann)
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("rns_modexp2_tc_kernel" in k for k in kernels)
    k5 = ann["kernels.k5"]
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e["name"].startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                and k5["ts"] <= e["ts"] <= k5["ts"] + k5["dur"]]
    assert launches
