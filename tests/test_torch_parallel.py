"""The port's data and context parallelism (``parallel/``, ``train/validate.py``, the
model's routing and the train step over a mesh) against the JAX package on the CPU:

- ``mesh_shape``'s axis inference against JAX's ``make_mesh`` for several device counts,
  the combined axes of a mesh with fsdp / pp / tp (slice 5b, no longer refused), and the
  refusal of nccl where ranks share a card;
- ``validate_launch`` / ``validate_model`` refusing what JAX's refuse, with its messages;
- the batch split: dp blocks of rows, cp slices of the sequence with labels aligned to
  positions, so no target is lost at a shard boundary;
- a 2-layer small Llama with LoRA (fp32): loss and adapter gradients at cp 2, ring and
  Ulysses in two gloo processes, against the JAX model with ``attn_impl="ring"`` /
  ``"ulysses"`` on a cp mesh of the 8-device simulation and against the port at cp 1;
- a dp 2 x cp 2 train step in four gloo processes equal to the single-process step (the
  counterpart of tests/test_parallel.py:77);
- the text trainer under ``torch.distributed.run`` (2 processes, ``--mesh '{"cp": 2}'
  --attn_impl ring``) against the same command on one process;
- attention dropout with ring attention raises, as in JAX.

Tolerances (fp32): losses 1e-5 relative, gradients 1e-4 of their largest entry (a model's
worth of re-ordered sums), the step's gradients 1e-5; the trainer's losses as it prints
them, to 2e-4 (two units of the fourth decimal). The ranks run in subprocesses that import
no JAX, with a file store (or torchrun's standalone rendezvous) and a timeout of their
own."""

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from llama_x_tpu.adapters import apply_linear_adapter as japply_adapter
from llama_x_tpu.adapters import trainable_mask as jtrainable_mask
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.parallel import make_mesh as jmake_mesh
from llama_x_tpu.parallel import use_mesh as juse_mesh
from llama_x_tpu.train import validate as jvalidate
from llama_x_tpu.utils.tree import merge, named_leaves, partition
from llama_x_tpu_torch.data import metamathqa as tdata
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.parallel import context as tcontext
from llama_x_tpu_torch.parallel import mesh as tmesh
from llama_x_tpu_torch.parallel.sharding import shard_batch
from llama_x_tpu_torch.train import cli as tcli
from llama_x_tpu_torch.train import validate as tvalidate
from llama_x_tpu_torch.train.trainer import TrainState, make_train_step
from torch_dist_workers import Recorder, run_ranks

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

MESH_CASES = [{}, dict(dp=2), dict(fsdp=2), dict(cp=2), dict(pp=2), dict(tp=2), dict(dp=2, cp=2), dict(cp=4),
              dict(dp=2, fsdp=2, tp=2), dict(dp=1, cp=2, tp=2), dict(dp=3), dict(cp=3), dict(fsdp=2, cp=2)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_infers_the_axes_as_jax_does(n):
    for kw in MESH_CASES:
        try:
            want = dict(jmake_mesh(devices=jax.devices()[:n], **kw).shape)
        except AssertionError:
            want = None
        if want is None:
            with pytest.raises(ValueError, match="devices"):
                tmesh.mesh_shape(n, **kw)
        else:
            assert tmesh.mesh_shape(n, **kw) == want, (n, kw)


def test_later_axes_and_flags_raise_naming_slice_5b():
    """Slice 5b is ported: a mesh with fsdp, pp or tp above 1 and ``--pp_microbatches`` no
    longer raise (their refusal is gone); the mesh's combined axes have the JAX layout's
    sizes and mixed-radix indices, and the flags of slice 2c still raise by name."""
    for shape in (tmesh.mesh_shape(4, dp=1), tmesh.mesh_shape(4, dp=2, pp=2), tmesh.mesh_shape(2, dp=1, tp=2)):
        for rank in range(int(np.prod(list(shape.values())))):
            mesh = tmesh.Mesh(shape, rank, None)
            c = mesh.coords()
            assert mesh.index("dp+fsdp") == c["dp"] * shape["fsdp"] + c["fsdp"]
            assert mesh.axis_size("dp+fsdp") == shape["dp"] * shape["fsdp"]
            assert mesh.axis_size("mesh") == mesh.size and mesh.index("mesh") == rank
    parser = argparse.ArgumentParser()
    tcli.add_common_args(parser)
    for argv in (["--mesh", '{"fsdp": 2}'], ["--mesh", '{"dp": 2, "tp": 2}'], ["--pp_microbatches", "4"]):
        tcli.check_supported(parser.parse_args(["--synthetic", "4", *argv]))
    tcli.check_supported(parser.parse_args(["--synthetic", "4", "--mesh", '{"tp": 2}', "--remat_policy", "attn_q8"]))
    tcli.check_supported(parser.parse_args(["--synthetic", "4", "--mesh", '{"dp": 2, "cp": 2}', "--attn_impl", "ring"]))
    tcli.check_supported(parser.parse_args(["--synthetic", "4", "--mesh", '{"cp": 2}', "--attn_impl", "ulysses"]))


def test_backends_are_named_and_never_switched(monkeypatch):
    with pytest.raises(ValueError, match="gloo"):
        tmesh.rank_device("nccl", "cpu", 0, 1)
    with pytest.raises(ValueError, match="backend"):
        tmesh.init_distributed("mpi", "cpu")
    assert tmesh.rank_device("gloo", "cpu", 1, 2) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)  # one card, two ranks on this host
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one device"):
        tmesh.rank_device("nccl", "cuda", 1, 2)
    assert [tmesh.rank_device("gloo", "cuda", r, 2) for r in (0, 1)] == [torch.device("cuda", 0)] * 2
    assert tmesh.rank_device("nccl", "cuda", 0, 1) == torch.device("cuda", 0)


def test_a_single_process_mesh_has_one_rank_and_no_collectives():
    mesh = tmesh.make_mesh()
    assert mesh.size == 1 and mesh.shape == tmesh.mesh_shape(1) and mesh.groups == {}
    t = torch.arange(4.0)
    assert tmesh.all_reduce(mesh, t) is t
    assert tmesh.RingExchange(mesh, [t]).wait()[0] is t


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def _args(**kw):
    base = dict(batch_size=4, gradient_accumulation=1, attn_impl="auto")
    base.update(kw)
    return argparse.Namespace(**base)


def _outcome(fn):
    try:
        fn()
        return None
    except ValueError as e:  # LaunchConfigError in both packages
        return str(e)


VALIDATE_CASES = [
    (dict(), _args()),
    (dict(cp=2), _args(attn_impl="ring")),
    (dict(cp=2), _args(attn_impl="ulysses")),
    (dict(), _args(attn_impl="ring")),
    (dict(cp=2), _args()),
    (dict(dp=2, cp=2), _args(attn_impl="ring", batch_size=4, gradient_accumulation=2)),
    (dict(dp=4), _args(batch_size=6, gradient_accumulation=2)),
    (dict(), _args(batch_size=5, gradient_accumulation=2)),
    (dict(cp=4), _args(attn_impl="ulysses")),
    (dict(cp=8), _args(attn_impl="ulysses")),
    (dict(dp=2, cp=2), _args(attn_impl="ring", batch_size=2)),
    # slice 5b: pp and tp (num_layers % pp, dropout with pp, ring with pp, num_kv_heads % tp)
    (dict(pp=2), _args()), (dict(pp=4), _args()), (dict(tp=2), _args()), (dict(dp=2, tp=2), _args()),
    (dict(cp=2, pp=2), _args(attn_impl="ring")), (dict(dp=2, pp=2), _args(batch_size=2)),
]


@pytest.mark.parametrize("mesh_kw,args", VALIDATE_CASES)
@pytest.mark.parametrize("cfg", [dict(), dict(attn_dropout=0.1), dict(num_heads=6, num_kv_heads=3, head_dim=16),
                                 dict(max_seq_len=100), dict(fused_ce_chunks=-1)])
def test_validate_refuses_what_jax_refuses(mesh_kw, args, cfg):
    n = int(np.prod(list(mesh_kw.values()) or [1]))
    jmesh = jmake_mesh(devices=jax.devices()[:n], fsdp=1, **mesh_kw)
    tm = tmesh.Mesh(tmesh.mesh_shape(n, fsdp=1, **mesh_kw), 0, None)
    for max_seq_len in (None, 96, 100):
        want = _outcome(lambda: jvalidate.validate_launch(args, jmesh, max_seq_len=max_seq_len))
        got = _outcome(lambda: tvalidate.validate_launch(args, tm, max_seq_len=max_seq_len))
        assert got == want, (mesh_kw, args, max_seq_len)
    jc, tc = jllama.tiny_config(**cfg), tllama.tiny_config(**cfg)
    assert _outcome(lambda: tvalidate.validate_model(tc, tm, args)) == _outcome(
        lambda: jvalidate.validate_model(jc, jmesh, args))


# ---------------------------------------------------------------------------
# the batch split
# ---------------------------------------------------------------------------


def test_split_after_the_shift_loses_no_target_at_a_shard_boundary():
    """The data's labels are the next tokens, aligned to positions (label t is the target
    of position t), so cutting inputs and labels at the same places keeps every target:
    the last position of a shard predicts the first input of the next."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 200, rng.integers(20, 90)).astype(np.int32) for _ in range(16)]
    it, _ = tdata.get_metamathqa("byte", True, 4, 256, tokens_list=docs)
    mb = next(it)
    batch = {k: v[None] for k, v in mb.items()}  # [accum 1, mb 4, S]
    inputs, labels = mb["inputs"], mb["labels"]
    S = inputs.shape[1]
    for dp, cp in ((1, 2), (2, 2), (4, 1), (1, 4)):
        got_in, got_lab, got_seg = [], [], []
        for rank in range(dp * cp):
            mesh = tmesh.Mesh(tmesh.mesh_shape(dp * cp, dp=dp, cp=cp), rank, None)
            rows = shard_batch(batch, mesh)
            assert rows["inputs"].shape == (1, 4 // dp, S)
            x = torch.from_numpy(rows["inputs"][0])
            lab = torch.from_numpy(rows["labels"][0])
            mi = MaskInfo(causal=True, segment_ids=torch.from_numpy(rows["segment_ids"][0]))
            xs, mis, labs = tcontext.shard_sequence(mesh, x[..., None], mi, lab)
            got_in.append((mesh.index("dp"), mesh.index("cp"), xs[..., 0]))
            got_lab.append((mesh.index("dp"), mesh.index("cp"), labs))
            got_seg.append((mesh.index("dp"), mesh.index("cp"), mis.segment_ids))
        for got, whole in ((got_in, inputs), (got_lab, labels), (got_seg, mb["segment_ids"])):
            rebuilt = torch.cat([torch.cat([t for d2, c, t in sorted(got, key=lambda e: e[1]) if d2 == d], dim=1)
                                 for d in range(dp)], dim=0)
            np.testing.assert_array_equal(rebuilt.numpy(), whole)
        for d, c, lab in got_lab:
            if c + 1 < cp:  # the boundary position's target is the next shard's first input
                nxt = [t for d2, c2, t in got_in if d2 == d and c2 == c + 1][0]
                keep = lab[:, -1] != -100
                np.testing.assert_array_equal(lab[keep, -1].numpy(), nxt[keep, 0].numpy())
    assert int((labels != -100).sum()) > 0


# ---------------------------------------------------------------------------
# the model and the train step at cp 2 and dp 2 x cp 2
# ---------------------------------------------------------------------------

FREEZE = ("tok_embeddings", "output", "norm")
CFG = dict(max_seq_len=64, num_layers=2, fused_ce_chunks=2)


def _fill_lora_b(layers, seed):
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                        if k == "lora_b" else fill(v)) for k, v in node.items()}
        return node

    return fill(layers)


def _lora_pair():
    jcfg = jllama.tiny_config(**CFG, frozen_head=True)
    params = jllama.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    layers = japply_adapter(params["layers"], "lora", jax.random.PRNGKey(1), rank=4, dtype=jnp.float32)
    params = dict(params, layers=_fill_lora_b(layers, 0))
    mask = jtrainable_mask(params, FREEZE)
    return params, jcfg, mask, jax.tree.map(np.asarray, params)


def _batch(seed, B=2, S=64):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100)], axis=1).astype(np.int32)
    labels[0, S // 2 - 1] = -100  # an ignored target right at the cp 2 boundary
    seg = np.sort(rng.integers(1, 4, (B, S)), axis=1).astype(np.int32)
    return tokens, labels, seg


def _port_model(np_params, **cfg):
    return params_from_jax(np_params, tllama.tiny_config(**CFG, frozen_head=True, **cfg), device="cpu",
                           freeze_prefixes=FREEZE)


def test_model_at_cp2_matches_jax_ring_and_the_port_at_cp1(tmp_path):
    params, jcfg, mask, np_params = _lora_pair()
    tokens, labels, seg = _batch(1)
    trainable, frozen = partition(params, mask)
    jmesh = JMesh(np.asarray(jax.devices()[:2]).reshape(2), ("cp",))
    want = {}
    for impl in ("ring", "ulysses"):
        def lfn(t, impl=impl):
            return jllama.forward(merge(t, frozen), jcfg.replace(attn_impl=impl), jnp.asarray(tokens),
                                  labels=jnp.asarray(labels), segment_ids=jnp.asarray(seg))
        with juse_mesh(jmesh):
            loss, grads = jax.jit(jax.value_and_grad(lfn))(trainable)
        want[impl] = (float(loss), {k: np.asarray(g) for k, g in named_leaves(grads)})
    # the port at cp 1 (one process, no mesh)
    model = _port_model(np_params)
    loss1 = tllama.forward(model, torch.from_numpy(tokens).long(), labels=torch.from_numpy(labels),
                           segment_ids=torch.from_numpy(seg))
    loss1.backward()
    cp1 = (float(loss1.detach()), named_tensors(model, grads=True))
    ranks = run_ranks(dict(kind="model", world=2, mesh=dict(cp=2), params=np_params, config=dict(CFG, frozen_head=True),
                           freeze=FREEZE, tokens=tokens, labels=labels, seg=seg, impls=["ring", "ulysses"]), tmp_path)
    for impl in ("ring", "ulysses"):
        got_loss, got = ranks[0][impl]
        for ref_loss, ref in (want[impl], cp1):
            assert got_loss == pytest.approx(ref_loss, rel=1e-5), impl
            assert set(got) == set(ref) and any("lora" in k for k in got)
            for name, w in ref.items():
                np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * np.abs(w).max() + 1e-7,
                                           err_msg=f"{impl} {name}")


def test_dp2_cp2_step_equals_the_single_process_step(tmp_path):
    _, _, _, np_params = _lora_pair()
    rng = np.random.default_rng(5)
    accum, mb, S = 2, 4, 64
    docs = [rng.integers(1, 250, rng.integers(10, 60)).astype(np.int32) for _ in range(32)]
    it, _ = tdata.get_metamathqa("byte", True, mb, S, tokens_list=docs)
    batch = tcli.assemble_step_batch([next(it) for _ in range(accum)], pad_values={"labels": -100})

    def loss_fn(m, b):
        loss = tllama.forward(m, b["inputs"].long(), segment_ids=b["segment_ids"], labels=b["labels"])
        return loss, (b["labels"] != -100).sum()

    model = _port_model(np_params)
    opt = Recorder([p for p in model.parameters() if p.requires_grad])
    metrics = make_train_step(loss_fn)(TrainState(model, opt), batch)
    ranks = run_ranks(dict(kind="step", world=4, mesh=dict(dp=2, cp=2), params=np_params,
                           config=dict(CFG, frozen_head=True), freeze=FREEZE, impl="ring", batch=batch), tmp_path)
    for r in ranks:  # every rank took the same update
        assert r["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-5)
        assert r["grad_norm"] == pytest.approx(float(metrics["grad_norm"]), rel=1e-5)
        assert r["n_tokens"] == int(metrics["n_tokens"])
        for g, w in zip(r["grads"], opt.grads):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-5 * float(w.abs().max()) + 1e-8)


def _losses(out: str) -> list[str]:
    return re.findall(r"step \d+: loss (\S+)", out)


def test_trainer_under_torchrun_at_cp2_matches_one_process(tmp_path):
    argv = ["-m", "llama_x_tpu_torch.train_metamathqa", "--device", "cpu", "--synthetic", "16", "--n_steps", "2",
            "--batch_size", "2", "--document_mask", "--max_seq_len", "128", "--log_interval", "1",
            "--ckpt_interval", "0", "--dtype", "float32", "--synthetic_config", '{"num_layers": 2}']
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    one = subprocess.run([sys.executable, *argv], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert one.returncode == 0, one.stdout[-2000:] + one.stderr[-2000:]
    two = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                          *argv, "--mesh", '{"cp": 2}', "--attn_impl", "ring"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert two.returncode == 0, two.stdout[-2000:] + two.stderr[-2000:]
    got, want = _losses(two.stdout), _losses(one.stdout)
    assert len(want) == 2 and len(got) == 2
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), atol=2e-4)
    assert len(list((tmp_path / "runs" / "metamathqa").iterdir())) == 2  # rank 0 alone wrote its run


def test_ring_with_attention_dropout_raises():
    _, _, _, np_params = _lora_pair()
    model = _port_model(np_params, attn_impl="ring", attn_dropout=0.1)
    tokens, labels, _ = _batch(2)
    with pytest.raises(ValueError, match="use_mesh"):
        tllama.forward(model, torch.from_numpy(tokens).long(), labels=torch.from_numpy(labels))
    with tmesh.use_mesh(tmesh.make_mesh()):
        with pytest.raises(NotImplementedError, match="dropout"):
            tllama.forward(model, torch.from_numpy(tokens).long(), labels=torch.from_numpy(labels),
                           dropout_seeds=[1, 2])
        # without seeds no dropout applies, and the ring runs (one rank)
        assert torch.isfinite(tllama.forward(model, torch.from_numpy(tokens).long(), labels=torch.from_numpy(labels)))
