"""The parts around the port's train step against the JAX package's, on the CPU: the LR
schedule and AdamW (fp32, 8-bit and 4-bit state) against optax, the low-bit state
codes, the data iterators, the adapter / freeze rules, and the trainer's command
line. The step itself and the model's gradients are in test_torch_train.py.

Tolerances are stated at each test."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.adapters import apply_linear_adapter as japply_adapter
from llama_x_tpu.adapters import quantize_linear as jquantize
from llama_x_tpu.adapters import trainable_mask as jtrainable_mask
from llama_x_tpu.data import metamathqa as jdata
from llama_x_tpu.data import synthetic as jsynth
from llama_x_tpu.data.tokenizers import get_tokenizer as jget_tokenizer
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.train import optim as joptim
from llama_x_tpu.utils.tree import named_leaves, trainable_param_count
from llama_x_tpu_torch import train_metamathqa as ttrain_cli
from llama_x_tpu_torch.adapters import lora as tlora
from llama_x_tpu_torch.data import metamathqa as tdata
from llama_x_tpu_torch.data import synthetic as tsynth
from llama_x_tpu_torch.data.tokenizers import get_tokenizer as tget_tokenizer
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.train import checkpoint as tckpt
from llama_x_tpu_torch.train import cli as tcli
from llama_x_tpu_torch.train import optim as toptim

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [(0.0, 0.0), (0.1, 0.0), (0.0, 0.2), (0.25, 0.25)])
def test_trapezoid_schedule_matches_jax(w):
    js = joptim.trapezoid_schedule(3e-4, 40, *w)
    ts = toptim.trapezoid_schedule(3e-4, 40, *w)
    for step in range(0, 45):
        assert ts(step) == pytest.approx(float(js(step)), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("name", ["AdamW", "AdamW8bit", "AdamW4bit"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_tracks_optax(name, dtype):
    """Five clipped, weight-decayed, scheduled steps on the same gradients: fp32
    parameters within 2e-6 after a total movement near 0.1 (the same fp32 formulas; a wrong
    term, such as a misplaced weight decay, would show at 1e-3), bf16 parameters bit for bit in all
    but a few elements that sit on a bf16 rounding tie (one ulp), because both sides
    add an fp32 update to the fp32 view and round once."""
    rng = np.random.default_rng(0)
    shapes = [(33, 20), (300,), (7, 5, 3)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10 ** rng.uniform(-3, 0) for s in shapes] for _ in range(5)]
    sched = (3e-2, 5, 0.4, 0.2)
    tx = joptim.get_optimizer(name, joptim.trapezoid_schedule(*sched), weight_decay=0.05, clip_grad_norm=0.5)
    jp = [jnp.asarray(p).astype(getattr(jnp, dtype)) for p in p0]
    jstate = tx.init([p.astype(jnp.float32) for p in jp])
    tp = [torch.from_numpy(p).to(getattr(torch, dtype)) for p in p0]
    opt = toptim.get_optimizer(name, tp, toptim.trapezoid_schedule(*sched), weight_decay=0.05, clip_grad_norm=0.5)
    for g in grads:
        pf = [p.astype(jnp.float32) for p in jp]
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, pf)
        jp = [(f + u).astype(p.dtype) for p, f, u in zip(jp, pf, updates)]
        opt.step([torch.from_numpy(x) for x in g])
    for a, b in zip(tp, jp):
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        if dtype == "float32" and name == "AdamW":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6)
        elif dtype == "float32":
            # a moment that sits on a code's rounding tie may take the neighbouring code on one side
            assert (np.abs(a - b) > 2e-6 + 1e-5 * np.abs(b)).mean() <= 0.01
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
        else:
            assert (a != b).mean() <= 0.01
            np.testing.assert_allclose(a, b, rtol=2**-7, atol=1e-6)
    assert opt.count == 5


@pytest.mark.parametrize("bits", [8, 4])
def test_low_bit_state_round_trip_matches_jax(bits):
    """Codes and scales of the blockwise sqrt-companded state, and their dequantized
    values, against the JAX package's: bit for bit (same fp32 formulas, elementwise)."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal(1000) * 10 ** rng.uniform(-6, 0, 1000)).astype(np.float32).reshape(25, 40)
    jq, js = joptim._quantize_state(jnp.asarray(x), bits=bits)
    tq, ts = toptim.quantize_state(torch.from_numpy(x), bits=bits)
    assert tq.dtype == torch.int8 and tuple(tq.shape) == jq.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = toptim.dequantize_state(tq, ts, x.shape, bits=bits)
    np.testing.assert_array_equal(back.numpy(), np.asarray(joptim._dequantize_state(jq, js, x.shape, bits=bits)))
    qmax = 127.0 if bits == 8 else 7.0
    assert float((back - torch.from_numpy(x)).abs().max()) <= float(np.abs(x).max()) * 2.0 / qmax


# ---------------------------------------------------------------------------
# data, adapters, CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["packed", "padding"])
def test_data_iterators_yield_the_jax_batches(mode):
    rng = np.random.default_rng(0)
    toks = [rng.integers(1, 300, rng.integers(8, 90)).astype(np.int32) for _ in range(37)]
    kw = dict(tokens_list=toks, seed=5)
    ji, jn = jdata.get_metamathqa("byte", mode == "packed", 3, 128, 32, **kw)
    ti, tn = tdata.get_metamathqa("byte", mode == "packed", 3, 128, 32, **kw)
    assert jn == tn == 37
    for _ in range(30):  # more than one epoch
        jb, tb = next(ji), next(ti)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
    want = jsynth.counting_tokens(5, 3, 40, jget_tokenizer("byte", None))
    got = tsynth.counting_tokens(5, 3, 40, tget_tokenizer("byte"))
    assert all(np.array_equal(a, b) for a, b in zip(want, got))
    with pytest.raises(NotImplementedError, match="slice 2b"):
        tdata.get_metamathqa("llama3", True, 1, 128)


@pytest.mark.parametrize("adapter", ["lora", "dora"])
@pytest.mark.parametrize("quantized", [False, True])
def test_apply_linear_adapter_and_freeze_rules_match_jax(adapter, quantized):
    """The port attaches the adapter the JAX transform attaches (shapes, dtypes, the
    zero lora_b, alpha / rank, DoRA's m equal to the base's norms, lora_a with the
    kaiming std) and marks trainable exactly the JAX mask's leaves, with its counts."""
    jcfg = jllama.tiny_config(max_seq_len=64)
    params = jllama.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    if quantized:
        params = dict(params, layers=jquantize(params["layers"], "int8"))
    model = params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(max_seq_len=64), device="cpu")
    params = dict(params, layers=japply_adapter(params["layers"], adapter, jax.random.PRNGKey(1), rank=4, alpha=6.0,
                                                dtype=jnp.float32))
    tlora.apply_linear_adapter(model.layers, adapter, torch.Generator().manual_seed(1), rank=4, alpha=6.0,
                               dtype=torch.float32)
    want = {n: np.asarray(v) for n, v in named_leaves(params)}
    got = named_tensors(model)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        if not name.endswith("lora_a"):
            np.testing.assert_allclose(got[name], w, rtol=1e-6, atol=0, err_msg=name)
    a = got["layers/feed_forward/w1/lora_a"]
    assert a.std() == pytest.approx((2.0 / 6.0) ** 0.5 / 64**0.5, rel=0.1)
    for freeze in ((), ("tok_embeddings", "output", "norm"), ("layers/attention",)):
        mask = jtrainable_mask(params, freeze)
        counts = tlora.set_trainable(model, freeze)
        assert counts == trainable_param_count(params, mask)
        want_names = {n for n, m in named_leaves(mask) if m}
        got_names = {tlora.tree_path(n) for n, p in model.named_parameters() if p.requires_grad}
        assert got_names == want_names
    with pytest.raises(ValueError, match="already has an adapter"):
        tlora.apply_linear_adapter(model.layers, adapter, torch.Generator().manual_seed(1))


def _args(*argv):
    import argparse

    parser = argparse.ArgumentParser()
    tcli.add_common_args(parser)
    return parser.parse_args(["--device", "cpu", *argv])


@pytest.mark.parametrize("flags,slice_name", [
    (["--mesh", '{"dp": 2}'], "slice 5"),
    (["--attn_impl", "ring"], "slice 5"),
    (["--model", "meta-llama/Llama-3.1-8B"], "slice 3"),
    (["--tokenizer", "llama3"], "slice 2b"),
    (["--remat_policy", "flash_q8s"], "slice 2b"),
    ([], "slice 2b"),  # no --synthetic: real data
])
def test_cli_refuses_later_slices_by_name(flags, slice_name):
    args = _args(*(flags if not flags else ["--synthetic", "8", *flags]))
    with pytest.raises(NotImplementedError, match=slice_name):
        tcli.check_supported(args)


def test_build_model_params_composes_quantize_adapt_freeze(capsys):
    args = _args("--synthetic", "8", "--quantize", "int8", "--quantize_kwargs",
                 '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}', "--adapter", "lora",
                 "--freeze_prefixes", "tok_embeddings", "output", "norm", "--fused_ce_chunks", "4",
                 "--activation_checkpointing", "--synthetic_config", '{"num_layers": 2, "embed_dim": 64}')
    model = tcli.build_model_params(args, max_seq_len=64)
    c = model.config
    assert (c.dynamic_int8_act, c.dynamic_int8_bwd, c.int8_head, c.frozen_head, c.activation_checkpointing,
            c.fused_ce_chunks, c.num_layers) == (True, True, True, True, True, 4, 2)
    lin = model.layers[0].attention.wq
    assert lin.int_data.dtype == torch.int8 and lin.lora_a.requires_grad and not lin.scale.requires_grad
    assert not model.output.weight.requires_grad and model.layers[0].ffn_norm.scale.requires_grad
    assert "No. of trainable params" in capsys.readouterr().out
    # an unfrozen head is seen as such
    args = _args("--synthetic", "8", "--synthetic_config", '{"num_layers": 1, "embed_dim": 64}')
    assert tcli.build_model_params(args, max_seq_len=64).config.frozen_head is False


def test_trainer_cli_runs_on_the_cpu(tmp_path, monkeypatch):
    """The entry point end to end: a few QLoRA steps on the counting task, metrics
    written, a checkpoint saved, and a resumed run that starts where it stopped."""
    monkeypatch.chdir(tmp_path)
    common = ["--device", "cpu", "--synthetic", "32", "--synthetic_task", "count", "--document_mask", "--max_seq_len",
              "64", "--batch_size", "4", "--gradient_accumulation", "2", "--quantize", "int8", "--quantize_kwargs",
              '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}', "--adapter", "lora",
              "--freeze_prefixes", "tok_embeddings", "output", "norm", "--fused_ce_chunks", "2",
              "--activation_checkpointing", "--lr", "1e-2", "--log_interval", "1", "--synthetic_config",
              '{"num_layers": 2, "embed_dim": 64, "intermediate_dim": 128, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16}']
    ttrain_cli.main([*common, "--n_steps", "4", "--run_name", "a"])
    (run,) = (tmp_path / "runs" / "metamathqa").iterdir()
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2, 3] and all(np.isfinite(r["loss"]) for r in recs)
    assert "toks_per_second" in recs[-1] and (run / "model_config.json").exists()
    assert tckpt.latest_checkpoint(run).name == "step_00000004"
    ttrain_cli.main([*common, "--n_steps", "6", "--run_name", "b", "--resume", str(run)])
    run_b = next(p for p in (tmp_path / "runs" / "metamathqa").iterdir() if p.name.startswith("b_"))
    recs_b = [json.loads(line) for line in (run_b / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs_b] == [4, 5]
