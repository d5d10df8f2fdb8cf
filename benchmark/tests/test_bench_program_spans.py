"""The readers of the program's spans (``benchmark/program_spans.py``): a traced tiny chat run
on the CPU, whose two per-request readers pair with the harness's observations and whose
two device readers find nothing to read (a device interval is timed on the card only); a
pairing fed a shifted lateness, and a program without the recorder, read nothing; the
device readers' arithmetic over a made-up window of spans, and a pairing that fails for
one request in it."""

import math
import statistics
import sys

import pytest

from benchmark import program_spans as ps
from benchmark import spec as spec_mod
from benchmark.run import Context
from benchmark.tests.tiny import make_root

PER_REQUEST = ("queue_wait_p95_ms.chat", "prefill_p95_ms.chat")
DEVICE = ("decode_step_ms.chat", "prefill_device_share.chat")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(spec, obs) of a traced tiny chat run of 2 s on the CPU."""
    root = make_root(tmp_path_factory.mktemp("bench"))
    spec = spec_mod.Spec(root)
    ctx = Context(spec, "tiny-chat", 2**31 + 77, 2.0, True, "cpu", log=lambda msg: None)
    out = spec_mod.kind(ctx.mix["kind"]).run(ctx)
    return spec, out["obs"]


def test_the_per_request_readers_pair_with_the_window(traced):
    spec, obs = traced
    reqs = ps.window_requests(obs)
    assert reqs is not None and len(reqs) == len(obs["late_ms"]) >= 3
    delivery = [ttft - late - r["queue_ms"] - r["prefill_ms"]
                for r, late, ttft in zip(reqs, obs["late_ms"], obs["ttft_ms"])]
    assert all(0 <= r["queue_ms"] and 0 <= r["prefill_ms"] for r in reqs)
    assert min(delivery) >= -ps.PAIRING_MS and abs(statistics.median(delivery)) <= ps.PAIRING_MS
    values = [spec.reader(name).read(obs) for name in PER_REQUEST]
    assert all(v is not None and math.isfinite(v) and v >= 0 for v in values)
    lo, hi = ps.window(obs, reqs)
    assert reqs[0]["submit"] - lo == round(obs["late_ms"][0] * 1e6) and hi - lo == round(obs["window_s"] * 1e9)


def test_the_device_readers_read_nothing_without_a_card(traced):
    spec, obs = traced
    assert [spec.reader(name).read(obs) for name in DEVICE] == [None] * 2


def test_a_shifted_lateness_does_not_pair(traced):
    spec, obs = traced
    shifted = dict(obs, late_ms=[x + 5.0 for x in obs["late_ms"]])
    assert ps.window_requests(shifted) is None
    assert [spec.reader(name).read(shifted) for name in PER_REQUEST + DEVICE] == [None] * 4


def test_a_program_without_the_recorder_reads_nothing(traced, monkeypatch):
    import llama_x_tpu_torch.utils as utils

    spec, obs = traced
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "llama_x_tpu_torch.utils.spans", None)
    assert [spec.reader(name).read(obs) for name in PER_REQUEST + DEVICE] == [None] * 4


def test_the_device_readers_over_a_made_up_window(monkeypatch, capsys):
    """The warm-up and two window requests (the first due at 0, sent 1 ms late, its TTFT 30
    ms: 10 ms in the queue, 19 ms of prefill; the second's TTFT 12 ms: 2 in the queue, 9 of
    prefill); in a window of 100 ms: an admission's copy (5 ms) and replay (15 ms, its
    launch's cut 5 ms more) under ``serve.admit``, then two decode steps (20 ms each) under
    ``serve.dispatch``. A second request whose TTFT leaves 2.5 ms unaccounted (a stalled
    host) still pairs; one whose TTFT is 2.5 ms short of its own spans (a wrong pairing)
    does not, nor two requests 2.5 ms over each."""
    from llama_x_tpu_torch.utils.spans import Span

    ms = 1_000_000
    t0 = 10**12
    made = iter(range(1, 100))

    def span(name, a, b, request=None, **attrs):
        return Span(name, next(made), None, request, 1, t0 + a * ms, t0 + b * ms, attrs)

    snap = [span("request.queue", -500, -499, 1, scheduler=3, reached=True),
            span("request.queue", 1, 11, 2, scheduler=3, reached=True),
            span("request.prefill", 11, 30, 2, scheduler=3, reached=True),
            span("request.queue", 40, 42, 4, scheduler=3, reached=True),
            span("request.prefill", 42, 51, 4, scheduler=3, reached=True),
            span("serve.admit", 0, 25), span("serve.dispatch", 25, 100),
            span("device.copy", 2, 7, stage="serve.admit"),
            span("device.replay", 10, 25, stage="serve.admit", graph="admit_row", cut_ns=5 * ms),
            span("device.replay", 30, 50, stage="serve.dispatch", graph="decode_rows step", cut_ns=0),
            span("device.replay", 80, 100, stage="serve.dispatch", graph="decode_rows step", cut_ns=0)]
    monkeypatch.setattr(ps, "_snapshot", lambda: (snap, 0))
    obs = dict(late_ms=[1.0, 1.0], ttft_ms=[30.0, 12.0], window_s=0.1)
    assert ps.decode_step_ms(obs) == pytest.approx(20.0)
    capsys.readouterr()
    assert ps.prefill_device_share(obs) == pytest.approx(100.0 * 20 / 60)
    # the admission's replay at 15 ms or at 20 ms with its cut: 20 / 60 to 25 / 65
    assert f"between {100 * 20 / 60:.3f}% and {100 * 25 / 65:.3f}%" in capsys.readouterr().err
    capsys.readouterr()
    assert ps.window_requests(dict(obs, ttft_ms=[30.0, 14.5])) is not None  # 2.5 ms unaccounted
    assert "1 above 2.0 ms, from 0.000 to 2.500 ms" in capsys.readouterr().err
    assert ps.window_requests(dict(obs, ttft_ms=[30.0, 9.5])) is None  # 2.5 ms short
    assert "the pairing does not hold" in capsys.readouterr().err
    assert ps.window_requests(dict(obs, ttft_ms=[32.5, 14.5])) is None  # the median 2.5 ms over
