"""HF import and export of the port (models/hf.py, export_checkpoint.py) against the
JAX package's loader and saver, on the CPU, over safetensors / .bin files that the tests
write from seeds.

Held, exactly (bit for bit): a checkpoint in one or three safetensors files or two .bin
files loads into the port's tensors as they were written and as the JAX loader loads
them; the port's save loads back through the JAX loader, and the JAX save through the
port's loader, both ways in bf16 and fp32; ``merged_weight`` (int8 dequantized, LoRA and
DoRA merged) equals the JAX ``_merged_kernel`` (1e-6: f32 products in another order);
quantize-on-load equals loading then ``quantize_linear``. Also: tied embeddings, skipped
buffers, the error listing unknown keys, a hub id refused without the network, the
streaming loader reading one tensor at a time (``LOAD_STATS``), the multimodal
``from_hf``, and ``export_checkpoint`` from a training run of the port into
``generate_cli --model`` (the exported model's logits equal the run's to 2e-4: LoRA
merged into an int8 base, fp32)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.adapters import apply_linear_adapter as japply_adapter
from llama_x_tpu.adapters.quantize import quantize_linear as jquantize
from llama_x_tpu.models import hf as jhf
from llama_x_tpu.models import llama as jllama
from llama_x_tpu_torch.adapters.quantize import quantize_linear
from llama_x_tpu_torch.models import hf as thf
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax

torch.set_num_threads(2)
D, L, NH, NKV, HD, F, V = 16, 3, 4, 2, 4, 32, 64


def _hf_weights(rng, dtype):
    def w(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32) * 0.1).to(dtype)

    sd = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": w(D), "lm_head.weight": w(V, D)}
    for i in range(L):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (NH * HD, D)), ("self_attn.k_proj", (NKV * HD, D)),
                            ("self_attn.v_proj", (NKV * HD, D)), ("self_attn.o_proj", (D, NH * HD)),
                            ("mlp.gate_proj", (F, D)), ("mlp.up_proj", (F, D)), ("mlp.down_proj", (D, F))):
            sd[p + name + ".weight"] = w(*shape)
        sd[p + "input_layernorm.weight"] = w(D)
        sd[p + "post_attention_layernorm.weight"] = w(D)
    return sd


def _write(d, sd, n_files=1, fmt="safetensors", tie=False, extra_config=None):
    cfg = {"architectures": ["LlamaForCausalLM"], "hidden_size": D, "num_hidden_layers": L, "head_dim": HD,
           "num_attention_heads": NH, "num_key_value_heads": NKV, "intermediate_size": F, "vocab_size": V,
           "rope_theta": 10000.0, "tie_word_embeddings": tie, **(extra_config or {})}
    (d / "config.json").write_text(json.dumps(cfg))
    keys = sorted(sd)
    for i in range(n_files):
        part = {k: sd[k] for k in keys[i::n_files]}
        if fmt == "safetensors":
            from safetensors.torch import save_file

            save_file(part, str(d / f"model-{i:05d}.safetensors"))
        else:
            torch.save(part, str(d / f"pytorch_model-{i:05d}.bin"))


_HF_OF = {"attention/wq": "self_attn.q_proj", "attention/wk": "self_attn.k_proj", "attention/wv": "self_attn.v_proj",
          "attention/wo": "self_attn.o_proj", "feed_forward/w1": "mlp.gate_proj", "feed_forward/w3": "mlp.up_proj",
          "feed_forward/w2": "mlp.down_proj"}


def _port_state(model):
    """{HF key: tensor} read off a port model (linears' float bases only)."""
    out = {"model.embed_tokens.weight": model.tok_embeddings, "model.norm.weight": model.norm.scale}
    if model.output is not None:
        out["lm_head.weight"] = model.output.weight
    for i, blk in enumerate(model.layers):
        for path, hf in _HF_OF.items():
            out[f"model.layers.{i}.{hf}.weight"] = blk.get_submodule(path.replace("/", ".")).weight
        out[f"model.layers.{i}.input_layernorm.weight"] = blk.attention_norm.scale
        out[f"model.layers.{i}.post_attention_layernorm.weight"] = blk.ffn_norm.scale
    return out


def _assert_trees_equal(port_model, jax_params):
    """The port's tensors equal the JAX tree's, bit for bit (layers stacked, kernels [in, out])."""
    ours = named_tensors(port_model)
    theirs = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v, np.float32)
              for p, v in jax.tree_util.tree_flatten_with_path(jax_params)[0]}
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


@pytest.mark.parametrize("fmt,n_files", [("safetensors", 1), ("safetensors", 3), ("bin", 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_import_is_exact_and_equals_the_jax_loader(tmp_path, fmt, n_files, dtype):
    sd = _hf_weights(np.random.default_rng(0), dtype)
    _write(tmp_path, sd, n_files, fmt)
    model = thf.load_llama(tmp_path, dtype=dtype, device="cpu")
    got = _port_state(model)
    assert set(got) == set(sd)
    for k, t in sd.items():
        assert torch.equal(got[k], t), k
    params, jcfg = jhf.load_llama(str(tmp_path), dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    _assert_trees_equal(model, params)
    c = model.config
    assert (c.embed_dim, c.num_layers, c.head_dim, c.num_heads, c.num_kv_heads, c.intermediate_dim, c.vocab_size,
            c.rope_base) == (jcfg.embed_dim, jcfg.num_layers, jcfg.head_dim, jcfg.num_heads, jcfg.num_kv_heads,
                             jcfg.intermediate_dim, jcfg.vocab_size, jcfg.rope_base)


def test_streaming_reads_one_tensor_at_a_time(tmp_path):
    sd = _hf_weights(np.random.default_rng(1), torch.bfloat16)
    _write(tmp_path, sd, 3)
    for k in thf.LOAD_STATS:
        thf.LOAD_STATS[k] = 0
    thf.load_llama(tmp_path, device="cpu")
    assert thf.LOAD_STATS["n_chunks"] == len(sd)
    assert thf.LOAD_STATS["max_chunk_bytes"] == max(t.numel() * 2 for t in sd.values())
    assert thf.LOAD_STATS["chunk_bytes"] == sum(t.numel() * 2 for t in sd.values())


def test_config_ties_buffers_errors_and_hub_ids(tmp_path):
    """Tied embeddings (no lm_head), a llama3 rope rescale, buffers that many checkpoints
    ship (skipped), unknown keys (one error naming them), a hub id (refused: no download)."""
    sd = _hf_weights(np.random.default_rng(2), torch.float32)
    del sd["lm_head.weight"]
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(2)
    rs = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
          "original_max_position_embeddings": 8192}
    _write(tmp_path, sd, tie=True, extra_config={"rope_scaling": rs, "rope_theta": 500000.0})
    model = thf.load_llama(tmp_path, dtype=torch.float32, device="cpu", max_seq_len=256)
    c = model.config
    assert model.output is None and c.tied_embeddings and c.is_llama3_1 and c.rope_scale_factor == 32.0
    assert c.max_seq_len == 256 and model.rope.shape[0] == 256
    _, jcfg = jhf.load_llama(str(tmp_path), dtype=jnp.float32)
    assert (jcfg.tied_embeddings, jcfg.is_llama3_1, jcfg.rope_scale_factor) == (True, True, 32.0)
    sd["model.layers.0.mystery.weight"] = torch.ones(2)
    bad = tmp_path / "bad"
    bad.mkdir()
    _write(bad, sd, tie=True)
    with pytest.raises(ValueError, match="mystery"):
        thf.load_llama(bad, device="cpu")
    with pytest.raises(FileNotFoundError, match="never downloads"):
        thf.load_llama("meta-llama/Llama-3.1-8B", device="cpu")


def _jax_model(adapter=None, quantize=False, seed=0):
    jcfg = jllama.tiny_config(embed_dim=64, num_layers=2, head_dim=32, num_heads=2, num_kv_heads=1,
                              intermediate_dim=128, vocab_size=256, max_seq_len=64)
    params = jllama.init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    if quantize:
        params = dict(params, layers=jquantize(params["layers"], "int8"))
    if adapter:
        layers = japply_adapter(params["layers"], adapter, jax.random.PRNGKey(seed + 1), rank=4, dtype=jnp.float32)
        rng = np.random.default_rng(seed)
        for grp in ("attention", "feed_forward"):
            for lin in layers[grp].values():
                lin["lora_b"] = jnp.asarray(rng.standard_normal(lin["lora_b"].shape).astype(np.float32) * 0.1)
                if "m" in lin:
                    lin["m"] = lin["m"] * jnp.asarray(1.0 + 0.1 * rng.standard_normal(lin["m"].shape), jnp.float32)
        params = dict(params, layers=layers)
    cfg_kw = dict(embed_dim=64, num_layers=2, head_dim=32, num_heads=2, num_kv_heads=1, intermediate_dim=128,
                  vocab_size=256, max_seq_len=64)
    return params, jcfg, params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(**cfg_kw), device="cpu")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_round_trips_both_ways_with_the_jax_package(tmp_path, dtype):
    """Port save -> JAX load, and JAX save -> port load: the tensors come back bit for
    bit (bf16: the fp32 weights rounded once, on both sides)."""
    params, jcfg, model = _jax_model()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    thf.save_llama_hf(model, tmp_path / "ours", dtype=dtype)
    back, _ = jhf.load_llama(str(tmp_path / "ours"), dtype=jdt)
    jhf.save_llama_hf(params, jcfg, tmp_path / "theirs", dtype=jdt)
    ours = thf.load_llama(tmp_path / "theirs", dtype=dtype, device="cpu")
    _assert_trees_equal(ours, back)
    again = thf.load_llama(tmp_path / "ours", dtype=dtype, device="cpu")
    for a, b in zip(again.state_dict().values(), ours.state_dict().values()):
        assert torch.equal(a, b)
    assert json.loads((tmp_path / "ours" / "config.json").read_text()) == json.loads(
        (tmp_path / "theirs" / "config.json").read_text()) | {"rms_norm_eps": jcfg.norm_eps}


@pytest.mark.parametrize("adapter,quantize", [("lora", True), ("dora", False), ("dora", True), (None, True)])
def test_merged_weight_equals_the_jax_merge(adapter, quantize, tmp_path):
    """LoRA and DoRA merged into the exported weight, an int8 base dequantized: the JAX
    ``_merged_kernel`` (transposed to [out, in]) to 1e-6; the export reloads to it."""
    params, _, model = _jax_model(adapter, quantize)
    for i in range(2):
        for grp, names in (("attention", ("wq", "wk", "wv", "wo")), ("feed_forward", ("w1", "w2", "w3"))):
            for n in names:
                want = np.asarray(jhf._merged_kernel_layer(params["layers"][grp][n], i)).T
                got = thf.merged_weight(getattr(getattr(model.layers[i], grp), n)).numpy()
                np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6, err_msg=f"{grp}/{n}[{i}]")
    thf.save_llama_hf(model, tmp_path, dtype=torch.float32)
    merged = thf.load_llama(tmp_path, dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 16)))
    with torch.inference_mode():
        torch.testing.assert_close(merged(tokens), model(tokens), atol=2e-4, rtol=2e-4)


def test_quantize_on_load_equals_load_then_quantize(tmp_path):
    sd = _hf_weights(np.random.default_rng(3), torch.bfloat16)
    _write(tmp_path, sd)
    q_on_load = thf.load_llama(tmp_path, device="cpu", quantize="int8")
    later = quantize_linear(thf.load_llama(tmp_path, device="cpu").layers, "int8")
    for (ka, a), (kb, b) in zip(q_on_load.layers.state_dict().items(), later.state_dict().items()):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka
    assert q_on_load.layers[0].attention.wq.int_data.dtype == torch.int8


def test_multimodal_from_hf(tmp_path):
    """LlamaAudio / LlamaVision / LlamaOmni.from_hf: the text weights of the checkpoint,
    stems drawn fresh from the seed (two loads with one seed agree)."""
    from llama_x_tpu_torch.models.audio import LlamaAudio
    from llama_x_tpu_torch.models.omni import LlamaOmni
    from llama_x_tpu_torch.models.vision import LlamaVision

    sd = _hf_weights(np.random.default_rng(4), torch.float32)
    _write(tmp_path, sd)
    for cls, kw in ((LlamaAudio, {}), (LlamaVision, dict(image_size=32, patch_size=8)), (LlamaOmni, dict(
            image_size=32, patch_size=8))):
        a = cls.from_hf(tmp_path, dtype=torch.float32, device="cpu", seed=3, **kw)
        b = cls.from_hf(tmp_path, dtype=torch.float32, device="cpu", seed=3, **kw)
        assert torch.equal(a.layers[1].feed_forward.w2.weight, sd["model.layers.1.mlp.down_proj.weight"])
        for (ka, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), (cls.__name__, ka)


def test_export_checkpoint_of_a_port_run_serves_through_generate_cli(tmp_path, monkeypatch, capsys):
    """A QLoRA run of the port's trainer (int8 base, LoRA r 8, 2 steps) exported to an HF
    directory: it loads, its logits equal the run's model's (LoRA merged), and
    ``generate_cli --model`` answers from it."""
    from llama_x_tpu_torch import export_checkpoint, generate_cli, train_metamathqa
    from llama_x_tpu_torch.train.checkpoint import restore_model

    monkeypatch.chdir(tmp_path)
    train_metamathqa.main(["--device", "cpu", "--synthetic", "16", "--n_steps", "2", "--batch_size", "2",
                           "--max_seq_len", "64", "--quantize", "int8", "--adapter", "lora", "--dtype", "float32",
                           "--lr", "1e-2", "--synthetic_config", '{"num_layers": 2, "embed_dim": 64}',
                           "--log_interval", "1", "--ckpt_interval", "0"])
    run = next((tmp_path / "runs" / "metamathqa").iterdir())
    out = export_checkpoint.main([str(run), str(tmp_path / "hf"), "--dtype", "float32", "--device", "cpu"])
    model = restore_model(run, "cpu")
    exported = thf.load_llama(out, dtype=torch.float32, device="cpu")
    assert any(float(lin.lora_b.detach().abs().max()) > 0 for lin in model.modules()
               if getattr(lin, "lora_b", None) is not None)  # the adapters trained
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 259, (2, 16)))
    with torch.inference_mode():
        torch.testing.assert_close(exported(tokens), model(tokens), atol=2e-4, rtol=2e-4)
    capsys.readouterr()
    generate_cli.main(["--model", str(out), "--device", "cpu", "--prompt", "2+2=", "--prompt", "hi",
                       "--max_new_tokens", "4", "--no_eos"])
    out = capsys.readouterr()
    assert out.out.startswith("2+2=") and "\nhi" in out.out and out.err.count("tok completion") == 2


def test_export_checkpoint_restores_on_the_card_by_default(monkeypatch):
    """With no ``--device`` the run is restored on the card (``restore_model(..., "cuda")``,
    which raises where there is none); ``--device cpu`` restores it on the host."""
    from llama_x_tpu_torch import export_checkpoint
    from llama_x_tpu_torch.train import checkpoint

    seen = []

    def restore(path, device=None):
        seen.append(device)
        raise RuntimeError("restored")

    monkeypatch.setattr(checkpoint, "restore_model", restore)
    for extra in ([], ["--device", "cpu"]):
        with pytest.raises(RuntimeError, match="restored"):
            export_checkpoint.main(["runs/metamathqa/run", "out", *extra])
    assert seen == ["cuda", "cpu"]
