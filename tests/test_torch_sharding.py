"""The port's parameter sharding (slice 5b: ``parallel/sharding.py``, ``parallel/tensor.py``,
the sharded linears, the vocabulary-parallel head, the trainer's reduction, the optimizer
and checkpoints under fsdp / tp) against the JAX package on the CPU:

- ``param_specs`` of every tensor (float, int8 + LoRA, DoRA, tied, with pp) equal to JAX
  ``param_specs`` of the same tiny model; ``shard_params`` keeps each rank's slices (uneven
  ones as GSPMD cuts them) and is idempotent;
- the fsdp 2 x tp 2 and dp 2 x tp 2 train steps in four gloo processes against the JAX step
  on the same mesh of the 8-device simulation: the float step of JAX
  ``test_fsdp_tp_step_matches_unsharded`` (AdamW) at that test's own tolerances (loss
  ``rtol=1e-5``, updated tensors ``rtol=1e-4``, ``atol=1e-5``), and the QLoRA step (int8 base
  with ``dynamic_int8_act`` / ``bwd``, ``int8_head``, LoRA, remat ``full``, fused CE) at the
  port's int8 tolerances (ROADMAP C, "int8 rounding ties": loss 2e-4; gradients 5e-3 of
  their largest entry, the grad-norm tolerance of the int8 curves: a sum taken in another
  order may flip one rounding tie of a later int8 code, which moves a gradient by about
  1e-3 of its largest entry, between the port and JAX and between tp and one process alike);
- trouble spot (a): the row-parallel quantizer's codes equal the unsharded ones;
- DoRA under tp 2 (the row-parallel column norm summed over tp), the vocabulary-parallel
  CE (plain and fused) with a vocabulary that does not divide by tp, ``--clip_grad_norm``
  under tp 2 (each replicated tensor counted once);
- (d): ``AdamW8bit`` under fsdp 2 equal to unsharded (blocks of the whole tensor), and
  why: a shard's own blocks give other codes;
- a checkpoint saved at tp 2 restores into one process, and one saved there restores at
  fsdp 2;
- ``from_hf(mesh=)`` at fsdp 2 x tp 2 (int8 on load) equal to the unsharded load's slices.

The ranks run in subprocesses of ``tests/torch_dist_workers.py`` (no JAX in them)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from llama_x_tpu.adapters import apply_linear_adapter as japply_adapter
from llama_x_tpu.adapters import quantize_linear as jquantize
from llama_x_tpu.adapters import trainable_mask as jtrainable_mask
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.parallel import batch_sharding, make_mesh as jmake_mesh, param_specs as jparam_specs
from llama_x_tpu.parallel import shard_params as jshard_params
from llama_x_tpu.train.trainer import init_train_state, make_train_step as jmake_train_step
from llama_x_tpu.utils.tree import merge, named_leaves, partition
from llama_x_tpu_torch.adapters.lora import tree_path
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.parallel import mesh as tmesh
from llama_x_tpu_torch.parallel import sharding as tsharding
from llama_x_tpu_torch.train import optim as toptim
from llama_x_tpu_torch.train.trainer import TrainState, make_train_step
from torch_dist_workers import Recorder, run_ranks

torch.set_num_threads(2)
QLORA_FREEZE = ("tok_embeddings", "output", "norm")


def _cfg(**kw):
    base = dict(embed_dim=64, num_layers=2, head_dim=16, num_heads=4, num_kv_heads=2, intermediate_dim=128,
                vocab_size=256, max_seq_len=64)
    base.update(kw)
    return base


def _fill_lora_b(layers, seed):
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                        if k == "lora_b" else fill(v)) for k, v in node.items()}
        return node

    return fill(layers)


def _jax_params(mode: str, **cfg):
    """(JAX params, JAX config, mask, freeze prefixes, port config fields) for "full" (float,
    everything trains), "qlora" (int8 base, dynamic int8 act / bwd, int8 head, LoRA, remat
    full, fused CE) or "dora" (float base + DoRA)."""
    kw = _cfg(**cfg)
    if mode == "qlora":
        kw.update(dynamic_int8_act=True, dynamic_int8_bwd=True, int8_head=True, fused_ce_chunks=4,
                  activation_checkpointing=True)
    jcfg = jllama.tiny_config(**kw)
    params = jllama.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    freeze = ()
    if mode == "qlora":
        params = dict(params, layers=jquantize(params["layers"], "int8"))
        freeze = QLORA_FREEZE
    if mode in ("qlora", "dora", "lora"):
        layers = japply_adapter(params["layers"], "lora" if mode == "qlora" else mode, jax.random.PRNGKey(1), rank=4,
                                dtype=jnp.float32)
        params = dict(params, layers=_fill_lora_b(layers, 0))
    mask = jtrainable_mask(params, freeze)
    head = mask["tok_embeddings"]["weight"] if jcfg.tied_embeddings else mask["output"]["kernel"]
    jcfg = jcfg.replace(frozen_head=not head)
    return params, jcfg, mask, freeze, dict(kw, frozen_head=not head)


def _batch(seed, vocab=256, accum=2, mb=4, S=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (accum, mb, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1).astype(np.int32)
    labels[..., -1] = -100
    return {"inputs": tokens, "labels": labels}


def _norm(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,cfg,pp", [("full", {}, False), ("qlora", {}, False), ("dora", {}, False),
                                         ("full", dict(tied_embeddings=True), False), ("qlora", {}, True)])
def test_param_specs_of_every_tensor_equal_jax(mode, cfg, pp):
    params, _, _, freeze, tcfg = _jax_params(mode, **cfg)
    want = {name: _norm(spec, np.ndim(leaf)) for (name, spec), (_, leaf) in
            zip(named_leaves(jparam_specs(params, pp=pp)), named_leaves(params))}
    model = params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(**tcfg), device="cpu",
                            freeze_prefixes=freeze)
    got = {}
    for name, spec in tsharding.param_specs(model, pp=pp).items():
        path = tree_path(name)
        if path.endswith("/kernel"):  # the port's weight [out, in] is the JAX kernel transposed
            spec = spec[:-2] + spec[-2:][::-1]
        got.setdefault(path, set()).add(spec)
    assert set(got) == set(want)
    for path, specs in got.items():
        assert specs == {want[path]}, (path, specs, want[path])
    assert any("int_data" in p for p in got) == (mode == "qlora")


def test_shard_params_keeps_each_ranks_slices_and_is_idempotent():
    """fsdp 2 x tp 2 over an uneven vocabulary (255 rows: 128 and 127) and pp 2: every rank's
    slices, put back together in rank order, give the whole tensors; a second call on the
    same mesh changes nothing."""
    params, _, _, freeze, tcfg = _jax_params("qlora", vocab_size=255)
    np_params = jax.tree.map(np.asarray, params)
    whole = params_from_jax(np_params, tllama.tiny_config(**tcfg), device="cpu", freeze_prefixes=freeze).state_dict()
    shape = tmesh.mesh_shape(4, fsdp=2, tp=2)
    parts = []
    for rank in range(4):
        model = params_from_jax(np_params, tllama.tiny_config(**tcfg), device="cpu", freeze_prefixes=freeze)
        mesh = tmesh.Mesh(shape, rank, None)
        tsharding.shard_params(model, mesh)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        assert tsharding.shard_params(model, mesh) is model
        assert all(torch.equal(v, model.state_dict()[k]) for k, v in sd.items())
        parts.append((mesh.coords(), model.state_dict(keep_vars=True)))
        assert model.layers[0].attention.wq.tp_kind == "col" and model.layers[0].feed_forward.w2.tp_kind == "row"
        assert model.tok_embeddings.shape[0] == (128 if mesh.index("tp") == 0 else 127)
    for name, t in whole.items():
        spec = getattr(parts[0][1][name], "shard_spec", ())
        got = None
        for tp in range(2):
            row = None
            for fsdp in range(2):
                piece = next(sd[name] for c, sd in parts if c["tp"] == tp and c["fsdp"] == fsdp).detach()
                if "fsdp" in spec:
                    row = piece if row is None else torch.cat([row, piece], dim=spec.index("fsdp"))
                else:
                    row = piece
            if "tp" in spec:
                got = row if got is None else torch.cat([got, row], dim=spec.index("tp"))
            else:
                got = row
        assert torch.equal(got, t), name
    model = params_from_jax(np_params, tllama.tiny_config(**tcfg), device="cpu", freeze_prefixes=freeze)
    tsharding.shard_params(model, tmesh.Mesh(tmesh.mesh_shape(2, pp=2), 1, None))
    assert [type(b).__name__ for b in model.layers] == ["RemoteBlock", "Block"]
    with pytest.raises(ValueError, match="already"):
        tsharding.shard_params(model, tmesh.Mesh(tmesh.mesh_shape(2, tp=2), 1, None))


# ---------------------------------------------------------------------------
# the sharded steps against the JAX step on the simulated mesh
# ---------------------------------------------------------------------------


def _jax_step_on_mesh(mode, mesh_kw, batch, tx):
    """The JAX trainer's step on the simulated mesh: (loss, {name: updated trainable})."""
    params, jcfg, mask, _, _ = _jax_params(mode)

    def loss_fn(p, mb):
        return jllama.forward(p, jcfg, mb["inputs"], labels=mb["labels"]), jnp.sum(mb["labels"] != -100)

    n = int(np.prod(list(mesh_kw.values())))
    mesh = jmake_mesh(devices=jax.devices()[:n], **mesh_kw)
    state = init_train_state(jshard_params(params, mesh), mask, tx)
    sh = batch_sharding(mesh)
    state, metrics = jax.jit(jmake_train_step(loss_fn, tx))(
        state, {k: jax.device_put(jnp.asarray(v), sh) for k, v in batch.items()})
    return float(metrics["loss"]), {n: np.asarray(v) for n, v in named_leaves(state["trainable"])}


def _jax_grads_on_mesh(mode, mesh_kw, batch):
    """Loss and gradients of the trainable tensors (mean over the accumulation axis, as the
    trainers take them) on the simulated mesh, the params placed by JAX ``shard_params``."""
    params, jcfg, mask, _, _ = _jax_params(mode)
    n = int(np.prod(list(mesh_kw.values())))
    mesh = jmake_mesh(devices=jax.devices()[:n], **mesh_kw)
    trainable, frozen = partition(jshard_params(params, mesh), mask)
    sh = NamedSharding(mesh, P(("dp", "fsdp")))

    def lfn(t, tok, lab):
        return jllama.forward(merge(t, frozen), jcfg, tok, labels=lab)

    vg = jax.jit(jax.value_and_grad(lfn))
    losses, grads = [], []
    for i in range(batch["inputs"].shape[0]):
        loss, g = vg(trainable, jax.device_put(jnp.asarray(batch["inputs"][i]), sh),
                     jax.device_put(jnp.asarray(batch["labels"][i]), sh))
        losses.append(float(loss))
        grads.append({k: np.asarray(v) for k, v in named_leaves(g)})
    return float(np.mean(losses)), {k: np.mean([g[k] for g in grads], axis=0) for k in grads[0]}


JAX_SPOT = ("layers/attention/wq/kernel", "layers/feed_forward/w2/kernel", "output/kernel")


@pytest.mark.parametrize("mesh_kw", [dict(dp=1, fsdp=2, tp=2), dict(dp=2, fsdp=1, tp=2)])
def test_fsdp_tp_and_dp_tp_steps_match_the_jax_step(tmp_path, mesh_kw):
    batch = _batch(1)
    full, _, _, _, full_cfg = _jax_params("full")
    qlora, _, _, qfreeze, q_cfg = _jax_params("qlora")
    want_loss, want_after = _jax_step_on_mesh("full", mesh_kw, batch, optax.adamw(1e-3))
    q_loss, q_grads = _jax_grads_on_mesh("qlora", mesh_kw, batch)
    # the port in one process: the float step's every tensor, beside the JAX step's spot checks
    one = params_from_jax(jax.tree.map(np.asarray, full), tllama.tiny_config(**full_cfg), device="cpu",
                          freeze_prefixes=())

    def loss_fn(m, mb):
        return tllama.forward(m, mb["inputs"].long(), labels=mb["labels"]), (mb["labels"] != -100).sum()

    opt = toptim.AdamW([p for p in one.parameters() if p.requires_grad], 1e-3, weight_decay=1e-4)
    make_train_step(loss_fn)(TrainState(one, opt), batch)
    one_after = named_tensors(one)
    ranks = run_ranks(dict(kind="sharded_step", world=4, mesh={k: v for k, v in mesh_kw.items() if v > 1}, cases=[
        dict(params=jax.tree.map(np.asarray, full), config=full_cfg, freeze=(), batch=batch,
             optim=dict(lr=1e-3, wd=1e-4)),
        dict(params=jax.tree.map(np.asarray, qlora), config=q_cfg, freeze=qfreeze, batch=batch),
    ]), tmp_path)
    for r in ranks:
        got = r[0]
        assert got["loss"][0] == pytest.approx(want_loss, rel=1e-5)
        for name in JAX_SPOT:
            np.testing.assert_allclose(got["after"][name], want_after[name], rtol=1e-4, atol=1e-5, err_msg=name)
        for name, w in one_after.items():
            np.testing.assert_allclose(got["after"][name], w, rtol=1e-4, atol=1e-5, err_msg=name)
        got = r[1]
        assert got["loss"][0] == pytest.approx(q_loss, rel=2e-4)
        by_path = {}
        for name, g in got["grads"].items():
            by_path.setdefault(tree_path(name), []).append(g)
        assert set(by_path) == set(q_grads)
        for path, w in q_grads.items():
            g = np.stack(by_path[path]) if path.startswith("layers/") else by_path[path][0]
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-3 * np.abs(w).max() + 1e-7, err_msg=path)


# ---------------------------------------------------------------------------
# tp 2: the quantizer, DoRA, the vocabulary-parallel CE, clipping
# ---------------------------------------------------------------------------


def _one_process(np_params, tcfg, freeze, batch, optim=None):
    model = params_from_jax(np_params, tllama.tiny_config(**tcfg), device="cpu", freeze_prefixes=freeze)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = Recorder(params) if optim is None else toptim.AdamW(params, optim["lr"], clip_grad_norm=optim.get("clip"),
                                                              state_bits=optim.get("bits"))

    def loss_fn(m, mb):
        return tllama.forward(m, mb["inputs"].long(), labels=mb["labels"]), (mb["labels"] != -100).sum()

    step = make_train_step(loss_fn)
    metrics = [step(TrainState(model, opt), batch) for _ in range(optim.get("steps", 1) if optim else 1)]
    grads = None if optim is not None else {n: g.numpy() for (n, p), g in
                                            zip([(n, p) for n, p in model.named_parameters() if p.requires_grad],
                                                opt.grads)}
    return metrics, grads, named_tensors(model), opt


def test_collectives_of_uneven_shards_over_each_axis(tmp_path):
    """``all_gather`` of uneven shards (an empty last one included), ``reduce_scatter`` by
    all-reduce and cut and by the backend's own reduce-scatter (padded to equal shards), and
    ``all_reduce`` with max, over one axis, the other and both, at fsdp 2 x tp 2; the bytes
    counted are the padded exchange's, copies included."""
    x = np.random.default_rng(5).standard_normal((5, 7)).astype(np.float32)
    ranks = run_ranks(dict(kind="collectives", world=4, mesh=dict(fsdp=2, tp=2), x=x, axes=("tp", "fsdp", "mesh")),
                      tmp_path)
    for r, got in enumerate(ranks):
        fsdp_i, tp_i = divmod(r, 2)
        groups = {"tp": ([2 * fsdp_i, 2 * fsdp_i + 1], tp_i), "fsdp": ([tp_i, 2 + tp_i], fsdp_i),
                  "mesh": ([0, 1, 2, 3], r)}
        for axis, (members, i) in groups.items():
            n = len(members)
            gathered, n_bytes = got[axis, "gather"]
            np.testing.assert_array_equal(gathered, x)
            assert n_bytes == x.shape[0] * -(-x.shape[1] // n) * 4 * n, axis
            lo, hi = tmesh.shard_bounds(x.shape[0], n, i)
            total = x * sum(m + 1 for m in members)
            for native in (False, True):
                part, n_bytes = got[axis, "scatter", native]
                np.testing.assert_allclose(part, total[lo:hi], rtol=1e-6, err_msg=f"{axis} native={native}")
                assert n_bytes == (-(-x.shape[0] // n) * n if native else x.shape[0]) * x.shape[1] * 4
            top, _ = got[axis, "max"]
            np.testing.assert_array_equal(top, np.maximum.reduce([x * (m + 1) for m in members]))


def test_tp2_quantizer_dora_vocab_parallel_ce_and_clipping(tmp_path):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 20)) * np.linspace(0.1, 3.0, 20)).astype(np.float32)
    h = rng.standard_normal((8, 16)).astype(np.float32)
    w = rng.standard_normal((255, 16)).astype(np.float32)  # 255 rows over tp 2: 128 and 127
    labels = rng.integers(0, 255, 8)
    labels[2] = -100
    dora, _, _, _, dora_cfg = _jax_params("dora")
    full, _, _, _, full_cfg = _jax_params("full", vocab_size=255)
    batch = _batch(4, vocab=255, accum=1, mb=2)
    units = run_ranks(dict(kind="units", world=2, mesh=dict(tp=2), x=x, h=h, w=w, labels=labels), tmp_path)
    steps = run_ranks(dict(kind="sharded_step", world=2, mesh=dict(tp=2), cases=[
        dict(params=jax.tree.map(np.asarray, dora), config=dora_cfg, freeze=(), batch=batch),
        dict(params=jax.tree.map(np.asarray, full), config=full_cfg, freeze=(), batch=batch),
        dict(params=jax.tree.map(np.asarray, full), config=dict(full_cfg, fused_ce_chunks=2), freeze=(), batch=batch),
        dict(params=jax.tree.map(np.asarray, full), config=full_cfg, freeze=(), batch=batch, steps=2,
             optim=dict(lr=1e-3, clip=0.05)),
    ]), tmp_path)
    # (a): the codes of the row's two halves, each quantized with the row's absmax over tp
    from llama_x_tpu_torch.ops.int8 import quantize_int8_rowwise

    q, s = quantize_int8_rowwise(torch.from_numpy(x))
    hg, wg = torch.from_numpy(h).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    from llama_x_tpu_torch.ops.cross_entropy import cross_entropy_loss

    ref = cross_entropy_loss(hg @ wg.T, torch.from_numpy(labels))
    ref_h, ref_w = torch.autograd.grad(ref, [hg, wg])
    for u in units:
        np.testing.assert_array_equal(u["codes"], q.numpy())
        np.testing.assert_array_equal(u["scale"], s.numpy())
        for kind in ("plain", "fused"):
            loss, gh, gw = u[kind]
            assert loss == pytest.approx(float(ref.detach()), rel=1e-6), kind
            np.testing.assert_allclose(gh, ref_h.numpy(), rtol=1e-5, atol=1e-7, err_msg=kind)
            np.testing.assert_allclose(gw, ref_w.numpy(), rtol=1e-5, atol=1e-7, err_msg=kind)
    cases = [(dora, dora_cfg, None), (full, full_cfg, None), (full, dict(full_cfg, fused_ce_chunks=2), None),
             (full, full_cfg, dict(lr=1e-3, clip=0.05, steps=2))]
    for i, (params, cfg, optim) in enumerate(cases):
        metrics, grads, after, _ = _one_process(jax.tree.map(np.asarray, params), cfg, (), batch, optim)
        for r in steps:
            got = r[i]
            assert got["loss"] == pytest.approx([float(m["loss"]) for m in metrics], rel=1e-5), i
            assert got["grad_norm"] == pytest.approx([float(m["grad_norm"]) for m in metrics], rel=1e-5), i
            if grads is not None:
                assert set(got["grads"]) == set(grads)
                for name, g in grads.items():
                    np.testing.assert_allclose(got["grads"][name], g, rtol=1e-4, atol=1e-4 * np.abs(g).max() + 1e-7,
                                               err_msg=f"case {i} {name}")
            else:  # clipped updates: the norm each rank clipped by is the whole model's (JAX's step tolerances)
                assert float(metrics[0]["grad_norm"]) > 0.05
                for name, w_ in after.items():
                    np.testing.assert_allclose(got["after"][name], w_, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mesh_kw", [dict(tp=2), dict(fsdp=2)])
def test_remat_policies_keep_their_saves_on_sharded_linears(tmp_path, mesh_kw):
    """The QLoRA step under the named-save policies ("dots", "flash_proj": the SaveStore hands
    the recompute the first pass's base outputs, a row-parallel one before its sum over tp)
    and the int8-residual MLP ("flash_q8s": h1 quantized with its row's absmax over tp) on a
    sharded model, against one process: loss and every gradient at the int8 tolerances."""
    qlora, _, _, qfreeze, q_cfg = _jax_params("qlora")
    np_params = jax.tree.map(np.asarray, qlora)
    batch = _batch(9, accum=1, mb=2)
    policies = ("dots", "flash_proj", "flash_q8s")
    ranks = run_ranks(dict(kind="sharded_step", world=2, mesh=mesh_kw, cases=[
        dict(params=np_params, config=dict(q_cfg, remat_policy=p), freeze=qfreeze, batch=batch) for p in policies]),
        tmp_path)
    for i, policy in enumerate(policies):
        metrics, grads, _, _ = _one_process(np_params, dict(q_cfg, remat_policy=policy), qfreeze, batch)
        for r in ranks:
            assert r[i]["loss"][0] == pytest.approx(float(metrics[0]["loss"]), rel=2e-4), policy
            for name, g in grads.items():
                np.testing.assert_allclose(r[i]["grads"][name], g, rtol=0, atol=5e-3 * np.abs(g).max() + 1e-7,
                                           err_msg=f"{policy} {name}")


# ---------------------------------------------------------------------------
# (d): the 8-bit optimizer state under fsdp; checkpoints; from_hf(mesh=)
# ---------------------------------------------------------------------------


def test_a_shards_own_blocks_would_give_other_codes():
    """Why the optimizer keeps the whole tensor's blocks: a [r, D] LoRA B sharded on D has
    a strided slice of the flattened tensor, whose 256-entry blocks are not the whole
    tensor's, so its blockwise absmax, codes and dequantized moments differ."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 96)).astype(np.float32))
    x[:, :48] *= 10.0  # the two shards' scales differ
    whole = toptim.dequantize_state(*toptim.quantize_state(x), x.shape)
    shard = toptim.dequantize_state(*toptim.quantize_state(x[:, 48:]), (8, 48))
    assert not torch.equal(whole[:, 48:], shard)


@pytest.mark.parametrize("bits", [8, 4])
def test_low_bit_adamw_under_fsdp2_equals_unsharded(tmp_path, bits):
    """Two AdamW8bit / AdamW4bit steps of a LoRA model at fsdp 2 against one process: the
    state's codes and block scales equal the unsharded ones (the whole tensor's blocks), the
    losses within 1e-5 and the parameters within the JAX step's tolerances. At 4 bits an
    entry whose second moment decodes to 0 takes an update of lr * mu / eps, which turns a
    rounding of its gradient (a sum in another order) into a visible step, so its
    parameters are held to 1e-2 relative."""
    full, _, _, _, cfg = _jax_params("lora")
    np_params = jax.tree.map(np.asarray, full)
    batch = _batch(6, accum=1, mb=4)
    optim = dict(lr=1e-2, bits=bits, steps=2)
    metrics, _, after, opt = _one_process(np_params, cfg, ("tok_embeddings", "output", "norm"), batch, optim)
    ranks = run_ranks(dict(kind="sharded_step", world=2, mesh=dict(fsdp=2), cases=[
        dict(params=np_params, config=cfg, freeze=("tok_embeddings", "output", "norm"), batch=batch, steps=2,
             optim=optim)]), tmp_path)
    want_state = opt.state_dict()
    tol = dict(rtol=1e-4, atol=1e-5) if bits == 8 else dict(rtol=1e-2, atol=1e-5)
    for r in ranks:
        got = r[0]
        assert got["loss"] == pytest.approx([float(m["loss"]) for m in metrics], rel=1e-5)
        for name, w in after.items():
            np.testing.assert_allclose(got["after"][name], w, err_msg=name, **tol)
        for key in ("mu", "nu"):  # the whole-tensor blocks: the unsharded layout, code for code
            for (gq, gs), (wq, ws) in zip(got["opt_state"][key], want_state[key]):
                assert torch.equal(gq, wq)
                np.testing.assert_allclose(gs.numpy(), ws.numpy(), rtol=1e-5)


def test_checkpoint_of_one_process_restores_at_tp2_and_back(tmp_path):
    """One process takes an AdamW8bit step and saves; two ranks at tp 2 restore that
    checkpoint into their shards, take the next step and save it whole (rank 0 writes);
    one process restores that and holds what it would have after both steps itself:
    the second step's loss, every tensor, the 8-bit moments code for code, the step."""
    from llama_x_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    lora, _, _, _, cfg = _jax_params("lora")
    np_params = jax.tree.map(np.asarray, lora)
    freeze = ("tok_embeddings", "output", "norm")
    batch = _batch(8, accum=1, mb=2)

    def state_of():
        model = params_from_jax(np_params, tllama.tiny_config(**cfg), device="cpu", freeze_prefixes=freeze)
        return TrainState(model, toptim.get_optimizer("AdamW8bit", [p for p in model.parameters() if p.requires_grad],
                                                      1e-2))

    def loss_fn(m, mb):
        return tllama.forward(m, mb["inputs"].long(), labels=mb["labels"]), (mb["labels"] != -100).sum()

    step = make_train_step(loss_fn)
    one = state_of()
    step(one, batch)
    save_checkpoint(tmp_path / "one", one, one.step)
    want_loss = float(step(one, batch)["loss"])
    losses = run_ranks(dict(kind="checkpoint", world=2, mesh=dict(tp=2), params=np_params, config=cfg, freeze=freeze,
                            batch=batch, load=str(tmp_path / "one" / "step_00000001"), save=str(tmp_path / "two")),
                       tmp_path)
    assert losses == pytest.approx([want_loss] * 2, rel=1e-5)
    back = state_of()
    restore_checkpoint(tmp_path / "two" / "step_00000002", back)
    assert back.step == one.step == 2
    for name, w in named_tensors(one.model).items():
        np.testing.assert_allclose(named_tensors(back.model)[name], w, rtol=1e-4, atol=1e-5, err_msg=name)
    got, want = back.optimizer.state_dict(), one.optimizer.state_dict()
    assert got["count"] == want["count"] == 2
    for key in ("mu", "nu"):
        for (gq, gs), (wq, ws) in zip(got[key], want[key]):
            assert (gq == wq).float().mean() > 0.999
            np.testing.assert_allclose(gs.numpy(), ws.numpy(), rtol=1e-4)


def test_from_hf_with_a_mesh_reads_each_ranks_slices(tmp_path):
    """``from_hf(path, mesh=)`` at fsdp 2 x tp 2 (a vocabulary of 255: uneven shards): every
    rank holds only its slices (the local shapes), and gathered whole they equal the
    unsharded load, float and int8 on load (the row's absmax taken over the axis that
    splits it), bit for bit."""
    from llama_x_tpu_torch.models.hf import save_llama_hf

    full, _, _, _, cfg = _jax_params("full", vocab_size=255)
    model = params_from_jax(jax.tree.map(np.asarray, full), tllama.tiny_config(**cfg), device="cpu")
    save_llama_hf(model, tmp_path / "hf", dtype=torch.float32)
    ranks = run_ranks(dict(kind="hf", world=4, mesh=dict(fsdp=2, tp=2), path=str(tmp_path / "hf")), tmp_path)
    for quantize in (None, "int8"):
        want = tllama.Llama.from_hf(tmp_path / "hf", dtype=torch.float32, device="cpu", quantize=quantize).state_dict()
        for r in ranks:
            got = r[quantize]
            assert set(got) == set(want)
            for name, w in want.items():
                np.testing.assert_array_equal(got[name], w.numpy(), err_msg=f"{quantize} {name}")
        local = ranks[0][f"{quantize}_local"]
        assert local["tok_embeddings"] == (128, 32)  # rows over tp, columns over fsdp
        key = "layers.0.attention.wq." + ("weight" if quantize is None else "int_data")
        assert local[key] == (32, 32)
