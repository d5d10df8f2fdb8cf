"""The hybrid chat kind (``benchmark/traffic/hybrid_chat_sessions.py``) at CPU size: its traffic
is made from the seed, a dry run loads no JAX and reads ``correct`` true while the control (the
reference at 4 bits) fails the limit, each of its faults reads ``correct`` false, and its
reference agrees with the program's plain forward. The tiny root is ``tiny.make_root``'s with
a tiny Nemotron-H configuration, mix and cell beside it. At this size the SSM state carries
little of the output unless its heads remember long (dt up to 0.01, not 0.1) over a wide state
(64): so configured, the state faults read above the sound run's ``logit_gap`` (0.09 and 0.34
against 0.04 at SEED over a 3 s window, the control 1.97); ``state_gap`` (SSM and conv) reads
0.024 sound, 0.35 for the control and 0.69-1.36 for each fault; ``lane_gap`` (the decode lanes
against the recurrence over the program's own inputs) 0.0018-0.0022 sound over three seeds,
0.0060-0.0067 for the state-precision control (a bfloat16 state in the decode steps) and 0.80
for a state reset. Each limit lies between its readings."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import MIXES, make_root
from benchmark.traffic import hybrid_chat_sessions as hybrid

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 91
CONFIG = dict(hidden_size=64, hybrid_override_pattern="M-*M-*M-", num_attention_heads=4, num_key_value_heads=2,
              attention_head_dim=16, intermediate_size=96, mamba_num_heads=8, mamba_head_dim=8, n_groups=2,
              ssm_state_size=64, conv_kernel=4, expand=2, vocab_size=256, max_position_embeddings=256,
              layer_norm_epsilon=1e-05, time_step_min=0.001, time_step_max=0.01, time_step_floor=0.0001,
              tie_word_embeddings=False, sliding_window=None, attention_bias=False)
MIX = dict(MIXES["tiny_chat"], kind="hybrid_chat_sessions")
CELL = dict(config="tiny_hybrid", traffic="tiny_hybrid_chat", chips=1,
            engine=dict(n_slots=4, chunk_size=4, prompt_multiple=16, prefill_chunk=16, prefix_cache=8,
                        warmup_prompt=200, warmup_tokens=4, trace_seconds=0.2, check_requests=16),
            limits=dict(logit_gap=0.06, state_gap=0.09, lane_gap=0.004))
WINDOW = 3.0  # seconds: 14 requests, follow-up turns among them (prefix hits over multi-chunk prompts)


def hybrid_root(tmp: Path) -> Path:
    root = make_root(tmp)
    (root / "benchmark/configs/tiny_hybrid.json").write_text(json.dumps(CONFIG))
    (root / "benchmark/traffic/tiny_hybrid_chat.json").write_text(json.dumps(MIX))
    (root / "benchmark/workloads/tiny-hybrid.json").write_text(json.dumps(CELL))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tiny_hybrid", source="test", file="benchmark/configs/tiny_hybrid.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="tiny-hybrid", config="tiny_hybrid", traffic="tiny_hybrid_chat", chips=1,
                                   why="test"))
    for m in bench["end_to_end"]:
        if m["name"] in ("ttft_p95_ms", "tpot_p95_ms", "serve_tokens_per_s"):
            m["workloads"].append("tiny-hybrid")
    real = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    for m in bench["per_layer"]:
        if "nemotronh47b-int8-chat" in real[m["name"]].get("workloads", []):
            m["workloads"] = m["workloads"] + ["tiny-hybrid"] if m["name"].endswith(".chat") else ["tiny-hybrid"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    return hybrid_root(tmp_path_factory.mktemp("bench"))


def run(root, **kw):
    return run_cell(root, "tiny-hybrid", SEED, WINDOW, False, "cpu", log=lambda msg: None, **kw)


def test_traffic_is_made_from_the_seed():
    a, b = hybrid.generate(MIX, CONFIG, 7, 3.0), hybrid.generate(MIX, CONFIG, 7, 3.0)
    c = hybrid.generate(MIX, CONFIG, 8, 3.0)
    assert a == b and a
    assert [(r["due"], len(r["prompt"]), r["max_tokens"]) for r in a] == [
        (r["due"], len(r["prompt"]), r["max_tokens"]) for r in c]
    assert [r["prompt"] for r in a] != [r["prompt"] for r in c]


def test_program_correct_and_control_fails(root):
    result = run(root, control=True)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["extra"]["control"]["logit_gap"] > CELL["limits"]["logit_gap"]
    assert result["extra"]["state_control"]["lane_gap"] > CELL["limits"]["lane_gap"]


@pytest.mark.parametrize("fault", sorted(hybrid.FAULTS))
def test_each_fault_reads_incorrect(root, fault):
    result = run(root, fault=fault)
    assert not result["correct"], (fault, result["checks"])


def test_faults_are_taken_out_after_their_run(root):
    run(root, fault="d_dropped")
    assert run(root)["correct"]


def test_traced_run_reads_the_hybrid_metrics(root):
    """A traced dry run: the program's own metrics read (on the CPU the device-trace and device
    interval readers find nothing to read)."""
    result = run_cell(root, "tiny-hybrid", SEED, WINDOW, True, "cpu", log=lambda msg: None)
    assert {"mfu.hchat", "prefix_reuse_share.chat", "queue_wait_p95_ms.chat", "prefill_p95_ms.chat",
            "ttft_p50_ms.chat", "sender_late_p95_ms.chat", "captures_in_window.chat"} <= set(result["metrics"])
    assert result["metrics"]["prefix_reuse_share.chat"]["value"] > 0


def test_reference_matches_the_program_in_float32():
    """The benchmark's reference (dual form, float32, no rounding) against the program's plain
    forward over the same drawn tensors, the model made float32: within 1e-4 of the logits'
    scale."""
    from benchmark import port_hybrid, weights_hybrid
    from benchmark.reference import nemotron_h as ref
    from llama_x_tpu_torch.models import nemotron_h

    cfg = dict(CONFIG, name="tiny_hybrid")
    t = weights_hybrid.draw(cfg, 3, "cpu")
    model = port_hybrid.build(cfg, t).float()
    toks = torch.randint(0, 256, (1, 40), generator=torch.Generator().manual_seed(1))
    got = nemotron_h.forward(model, toks)[0]
    (want,), states = ref.logits(cfg, t, [toks[0]], [torch.arange(40)], dict(act=None, kv=None), keep=[0])
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    # the reference's state after the sequence against the program's lanes after the same span
    ssm, conv = nemotron_h.init_states(model.config, 1, "cpu", torch.float32)
    zero = torch.zeros(1, dtype=torch.int64)
    from llama_x_tpu_torch.models import llama
    from llama_x_tpu_torch.ops.attention import MaskInfo

    nemotron_h.trunk(model, llama.embed(model, toks), MaskInfo(causal=True),
                     states=nemotron_h.Span(ssm, conv, zero, zero + 40, fresh=True))
    assert hybrid.state_gap(list(zip(ssm[:, 0], conv[:, 0])), states[0]) <= 1e-4
    assert hybrid.lane_gap((ssm[0, 0], conv[0, 0]), states[0][0]) <= 1e-4
    # the lane check's recurrence over the program's own in_proj rows of the first block
    lane = hybrid._lane_inputs(model, (toks[0].tolist(), 40, (ssm[0, 0], conv[0, 0])))
    w0 = {n: t[n][0].float() for n in ("conv_w", "conv_b", "A_log", "dt_bias", "D")}
    assert hybrid.lane_gap(lane[2], ref.mamba_state(cfg, w0, lane[3].float(), lane[4].float())) <= 1e-4


def test_dry_run_loads_no_jax(tmp_path):
    root = hybrid_root(tmp_path)
    code = ("import sys\nfrom benchmark.run import run_cell\n"
            f"r = run_cell({str(root)!r}, 'tiny-hybrid', 5, 0.3, False, 'cpu', log=lambda m: None)\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'llama_x_tpu'})\n"
            "assert not bad, bad\nassert r['correct'], r['checks']\n")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
