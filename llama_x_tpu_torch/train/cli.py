"""Shared trainer plumbing for the command-line entry points (port of
llama_x_tpu/train/cli.py): the common flags, model construction with the quantize ->
adapt -> freeze composition (with an audio stem, a patch-embed stem or both for the
multimodal trainers), the model config beside the checkpoints, optimizer set-up,
step-batch assembly and its prefetch onto the device (``prefetch``, ``device_batches``).

Real MetaMathQA text is read from its token cache (data/metamathqa.py); a missing cache is
refused by name (``check_supported``). ``--model`` reads a local HF checkpoint directory
(models/hf.py). ``--profile`` traces steps 5 and 6 (train/metrics.py: ``Profiler``) and cuts
the run to 10 steps, as the JAX trainers do; ``--project`` names a wandb project, used where
wandb can be imported.

Parallelism: ``--mesh '{"dp": D, "fsdp": F, "pp": P, "cp": C, "tp": T}'`` under
``torch.distributed.run`` (D x F x P x C x T processes; ``--attn_impl ring`` or ``ulysses``
with cp, ``--pp_microbatches`` with pp). ``setup_mesh`` joins the process group
(``--dist_backend``: nccl on the card, one card per rank; gloo on the CPU, or when ranks
share a card), builds the mesh and validates the flags; ``place_model`` shards the built
model's parameters over fsdp / tp / pp (parallel/sharding.py); ``run_training`` gives each
rank its block of every step batch, and rank 0 alone writes the run directory (every rank
takes part in gathering a checkpoint). With a pp axis each trainer's loss is the GPipe
schedule (``parallel/pipeline.py``) over ``pp_microbatch_count`` microbatches.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from llama_x_tpu_torch.adapters.lora import apply_linear_adapter, set_trainable
from llama_x_tpu_torch.adapters.quantize import quantize_linear
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from llama_x_tpu_torch.parallel.sharding import shard_batch, shard_params
from llama_x_tpu_torch.train.optim import get_optimizer, trapezoid_schedule
from llama_x_tpu_torch.train.validate import validate_launch
from llama_x_tpu_torch.train.trainer import trainable_parameters
from llama_x_tpu_torch.utils.device import resolve_device

REMAT_POLICIES = list(llama.REMAT_POLICIES)


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("--model", help="a local HF checkpoint directory (the text weights)")
    parser.add_argument("--tokenizer", default="byte", choices=["byte", "llama2", "llama3"],
                        help="the real-data tokenizer (--synthetic always uses byte)")
    parser.add_argument("--tokenizer_path", help="local tokenizer.model of llama2 / llama3 (offline)")
    parser.add_argument("--adapter", choices=["lora", "dora"])
    parser.add_argument("--adapter_kwargs", type=json.loads, default=dict())
    parser.add_argument("--quantize", choices=["int8"])
    parser.add_argument("--quantize_kwargs", type=json.loads, default=dict(),
                        help='{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}')
    parser.add_argument("--freeze_prefixes", nargs="+", default=[])
    parser.add_argument("--activation_checkpointing", action="store_true")

    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--n_steps", type=int, default=1000)
    parser.add_argument("--gradient_accumulation", type=int, default=1)

    parser.add_argument("--optim", default="AdamW", choices=["AdamW", "AdamW8bit", "AdamW4bit"])
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--warmup", type=float, default=0.0)
    parser.add_argument("--decay", type=float, default=0.0)
    parser.add_argument("--clip_grad_norm", type=float)

    parser.add_argument("--ckpt_interval", type=int, default=1000)
    parser.add_argument("--log_interval", type=int, default=50)
    parser.add_argument("--run_name")
    parser.add_argument("--project", help="a wandb project (logged there where wandb can be imported)")
    parser.add_argument("--profile", action="store_true",
                        help="trace steps 5 and 6 into <run>/profile (torch.profiler); the run stops after 10 steps")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--skip_nonfinite", action="store_true", help="suppress updates on NaN/Inf grads")
    parser.add_argument("--resume", help="a run directory or step directory of this trainer's checkpoints")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])

    parser.add_argument("--mesh", type=json.loads, default=dict(),
                        help='the mesh, e.g. \'{"dp": 2, "cp": 2}\', \'{"fsdp": 2, "tp": 2}\' or \'{"dp": 2, "pp": 2}\' '
                             "(one process a rank, under torch.distributed.run)")
    parser.add_argument("--dist_backend", choices=["nccl", "gloo"],
                        help="the process group's backend: default nccl on the card (one card per rank), gloo on the "
                             "CPU; gloo when ranks share a card")
    parser.add_argument("--pp_microbatches", type=int, default=0,
                        help="GPipe microbatches with a pp mesh axis (default: the pp size, or the gcd with the local "
                             "batch)")
    parser.add_argument("--attn_impl", default="auto", choices=["auto", "flash", "ring", "ulysses"])
    parser.add_argument("--remat_policy", default="full", choices=REMAT_POLICIES)
    parser.add_argument("--fused_ce_chunks", type=int, default=0)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic samples with the byte tokenizer and a random model")
    parser.add_argument("--synthetic_task", default="random", choices=["random", "count"],
                        help="random: unlearnable smoke tokens; count: learnable counting sequences")
    parser.add_argument("--synthetic_config", type=json.loads, default=dict(),
                        help='overrides of the small model\'s geometry, e.g. \'{"num_layers":8,"embed_dim":512}\', '
                             "or of --geometry's (a depth cut: '{\"num_layers\": 2}')")
    parser.add_argument("--geometry", choices=["tiny", "1b", "8b"],
                        help="random weights at a published width, made on the device (as generate_cli has it); "
                             "default: the small model")


def check_supported(args, real_data: Path | None = None) -> None:
    """Refuse, by name, a real dataset the trainer cannot read. ``real_data``: the token
    cache the trainer reads its real dataset from (train_metamathqa), which must exist, or
    None where ``--dataset_dir`` reads it. ``--synthetic`` needs neither."""
    if args.synthetic:
        return
    if real_data is not None:
        if not Path(real_data).exists():
            raise FileNotFoundError(f"no token cache {real_data} for the real dataset: the port downloads nothing "
                                    "(data/metamathqa.py: tokenize_metamathqa writes it from local records); "
                                    "pass --synthetic N")
    elif not args.dataset_dir:
        raise ValueError("--dataset_dir required (or --synthetic N)")


def setup_mesh(args, modality: str = "text", max_seq_len: int | None = None) -> Mesh:
    """The trainer's mesh: with ``--mesh``, join the process group of torchrun's ranks (the
    backend ``--dist_backend`` or, by default, nccl on the card and gloo on the CPU), point
    ``args.device`` at this rank's device and build the mesh; without it a mesh of one
    rank. Then ``validate_launch``. Every rank calls it."""
    if args.mesh:
        backend = args.dist_backend or ("gloo" if torch.device(args.device).type == "cpu" else "nccl")
        args.device = str(init_distributed(backend, args.device))
    mesh = make_mesh(**args.mesh)
    validate_launch(args, mesh, modality=modality, max_seq_len=max_seq_len)
    return mesh


def place_model(model, mesh: Mesh):
    """Shard the built model's parameters over the mesh's fsdp / tp / pp axes (each rank
    keeps its slices: parallel/sharding.py); a model on a mesh without them stays whole."""
    if any(mesh.axis_size(a) > 1 for a in ("fsdp", "pp", "tp")):
        shard_params(model, mesh)
    return model


def pp_microbatch_count(args, mesh: Mesh, micro_bs: int) -> int:
    """GPipe microbatches for the pp trainer path: --pp_microbatches, else the pp size
    (falling back to the gcd when the local batch does not divide). Shared by every trainer
    with a pp mode."""
    import math

    pp = mesh.shape.get("pp", 1)
    dp_size = mesh.shape.get("dp", 1) * mesh.shape.get("fsdp", 1)
    local_bs = micro_bs // dp_size
    n_micro = args.pp_microbatches or (pp if local_bs % pp == 0 else math.gcd(local_bs, pp))
    assert local_bs % n_micro == 0, (
        f"local batch {local_bs} (batch {micro_bs} / data-parallel {dp_size}) must "
        f"divide into --pp_microbatches {n_micro}"
    )
    if n_micro < pp:
        print(f"warning: {n_micro} pipeline microbatches < {pp} stages — large bubble")
    return n_micro


def make_save_dir(task: str, run_name: str | None) -> Path:
    name = f"{run_name or 'run'}_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
    d = Path("runs") / task / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def save_model_config(save_dir: Path, config, audio_config=None, vision_config=None) -> None:
    """The model hyperparameters beside the checkpoints, so that a later reader (the
    evaluations' ``--resume``) can rebuild the architecture."""
    import dataclasses

    record = {"llama": dataclasses.asdict(config)}
    if audio_config is not None:
        record["audio"] = dataclasses.asdict(audio_config)
    if vision_config is not None:
        record["vision"] = dataclasses.asdict(vision_config)
    (Path(save_dir) / "model_config.json").write_text(json.dumps(record, indent=2))


def load_model_configs(run_dir: Path):
    """(LlamaConfig, AudioConfig | None, VisionConfig | None) from a run directory's
    model_config.json, or None where there is none."""
    from llama_x_tpu_torch.models.audio import AudioConfig
    from llama_x_tpu_torch.models.vision import VisionConfig

    p = Path(run_dir) / "model_config.json"
    if not p.exists():
        return None
    rec = json.loads(p.read_text())
    return (llama.LlamaConfig(**rec["llama"]), AudioConfig(**rec["audio"]) if "audio" in rec else None,
            VisionConfig(**rec["vision"]) if "vision" in rec else None)


def build_model_params(args, max_seq_len: int = 2048, audio_config=None, vision_config=None,
                       vocab_size: int | None = None):
    """Random init (or ``--model``: a local HF checkpoint, quantized as it loads) ->
    quantize -> adapt -> freeze, in the JAX trainer's order, and
    ``frozen_head`` read off the head's actual ``requires_grad``. With ``audio_config``
    the model is a ``LlamaAudio``, with ``vision_config`` a ``LlamaVision``, with both a
    ``LlamaOmni``: freshly drawn stems beside the decoder, audio first (never quantized,
    never adapted; ``--freeze_prefixes audio_embed patch_embed`` freezes them).
    ``vocab_size``: the ids the data's tokenizer gives; the small model's vocabulary
    grows to hold them, a ``--geometry`` that cannot raises. Returns the model; prints
    the trainable / frozen counts."""
    from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    overrides = dict(activation_checkpointing=args.activation_checkpointing, fused_ce_chunks=args.fused_ce_chunks,
                     remat_policy=args.remat_policy, max_seq_len=max_seq_len, attn_impl=args.attn_impl)
    quantize = args.quantize == "int8"
    if args.model:
        from llama_x_tpu_torch.models.hf import load_llama

        model = load_llama(args.model, dtype=dtype, device=device, quantize=args.quantize, **overrides)
        if vocab_size is not None and vocab_size > model.config.vocab_size:
            raise ValueError(f"the tokenizer's {vocab_size} ids do not fit the checkpoint's vocabulary of "
                             f"{model.config.vocab_size}")
    elif args.geometry:
        # weights drawn directly as int8 at a published width (an 8B base never exists in float)
        config = llama.LlamaConfig(**GEOMETRIES[args.geometry]).replace(**{**(args.synthetic_config or {}), **overrides})
        if vocab_size is not None and vocab_size > config.vocab_size:
            raise ValueError(f"the tokenizer's {vocab_size} ids do not fit the {args.geometry} vocabulary of "
                             f"{config.vocab_size}")
        model = build_model(config, quantize, args.seed, device)
    else:
        geo = dict(embed_dim=256, num_layers=4, head_dim=32, num_heads=8, num_kv_heads=4, intermediate_dim=512,
                   vocab_size=512)
        geo.update(args.synthetic_config or {})
        geo["vocab_size"] = max(geo["vocab_size"], vocab_size or 0)
        config = llama.tiny_config(**geo).replace(**overrides)
        model = llama.init(config, seed=args.seed, dtype=dtype, device=device)
        if quantize:
            quantize_linear(model.layers, "int8")
    if quantize:
        kw = args.quantize_kwargs
        model.config = model.config.replace(
            dynamic_int8_act=bool(kw.get("dynamic_int8_act", False)),
            dynamic_int8_bwd=bool(kw.get("dynamic_int8_bwd", False)),
            int8_head=bool(kw.get("int8_head", False)),
        )
    if args.adapter:
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        apply_linear_adapter(model.layers, args.adapter, gen, dtype=dtype, **args.adapter_kwargs)
    if audio_config is not None or vision_config is not None:
        from llama_x_tpu_torch.models.audio import LlamaAudio, init_audio_stem
        from llama_x_tpu_torch.models.omni import LlamaOmni
        from llama_x_tpu_torch.models.vision import LlamaVision, init_patch_embed

        gen = torch.Generator(device=device).manual_seed(args.seed + 2)
        stem_dtype = torch.bfloat16 if args.geometry else dtype
        audio_stem = None if audio_config is None else init_audio_stem(model.config, audio_config, gen, stem_dtype)
        patch_stem = None if vision_config is None else init_patch_embed(model.config, vision_config, gen, stem_dtype)
        if patch_stem is None:
            model = LlamaAudio.from_llama(model, audio_stem, audio_config)
        elif audio_stem is None:
            model = LlamaVision.from_llama(model, patch_stem, vision_config)
        else:
            model = LlamaOmni.from_llama(model, audio_stem, patch_stem, audio_config, vision_config)
    n_train, n_frozen = set_trainable(model, tuple(args.freeze_prefixes))
    # frozen_head from the ACTUAL requires_grad, so that the fused-CE backward skips the
    # head's gradient exactly when the optimizer would never see it
    head_weight = model.tok_embeddings if model.config.tied_embeddings else model.output.weight
    model.config = model.config.replace(frozen_head=not head_weight.requires_grad)
    print(f"No. of trainable params: {n_train:,}")
    print(f"No. of non-trainable params: {n_frozen:,}")
    return model


def setup_optimizer(args, model):
    schedule = trapezoid_schedule(args.lr, args.n_steps, args.warmup, args.decay)
    optimizer = get_optimizer(args.optim, trainable_parameters(model), schedule, args.weight_decay,
                              args.clip_grad_norm, mesh=getattr(model, "mesh", None))
    return optimizer, schedule


def assemble_step_batch(micro_batches: list[dict], pad_values: dict | None = None) -> dict:
    """Stack accumulation microbatches into [accum, mb, ...] numpy arrays, padding
    ragged sequence lengths up to the step's longest (the bucketed padding mode yields
    a few distinct lengths)."""
    pad_values = pad_values or {}
    out = {}
    for k in micro_batches[0].keys():
        arrs = [mb[k] for mb in micro_batches]
        max_len = max(a.shape[-1] for a in arrs)
        pv = pad_values.get(k, 0)
        arrs = [
            np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, max_len - a.shape[-1])], constant_values=pv)
            if a.shape[-1] != max_len else a
            for a in arrs
        ]
        out[k] = np.stack(arrs)
    return out


def prefetch(it, depth: int = 2):
    """Draw ``it`` on a background thread, ``depth`` items ahead, so that batch assembly and
    the device copy overlap the running step. An exception of the producer crosses to the
    consumer and is raised there (a bare end marker would turn a failure of the data
    pipeline into a silent end of data)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def device_batches(batches, device, depth: int = 2):
    """The step batches of ``batches`` (dicts of numpy arrays) as tensors on ``device``,
    prefetched ``depth`` ahead on a background thread (``prefetch``). On the card each array is
    pinned and copied with ``non_blocking`` on a side stream; the consumer's stream waits on the
    copy's event and ``record_stream`` keeps the buffers alive for it, so the copy of the next
    batch overlaps the current step instead of queueing behind it on the default stream. The
    train step then copies each microbatch device to device into its graph's input buffers
    (train/step_graph.py): a step reads them while the next batches are being copied, so the
    prefetch cannot write there itself."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from prefetch(({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()} for b in batches),
                            depth)
        return
    stream = torch.cuda.Stream(device)

    def copies():
        for b in batches:
            with torch.cuda.stream(stream):
                out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)
                       for k, v in b.items()}
                done = torch.cuda.Event()
                done.record(stream)
            yield out, done

    for out, done in prefetch(copies(), depth):
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in out.values():
            t.record_stream(current)
        yield out


def run_training(args, model, data_iter, loss_fn, task: str, audio_config=None, vision_config=None,
                 audio_secs_per_step: float = 0.0, mesh: Mesh | None = None) -> None:
    """The trainers' loop (the JAX trainers' ``main`` after their set-up): optimizer,
    ``--resume``, the run directory with its model config, metrics every
    ``--log_interval`` steps, checkpoints every ``--ckpt_interval`` steps and at the end.
    ``data_iter`` yields microbatches; the label-token count is summed on the device
    between log points, so no step reads back. The step batches (accumulation microbatches
    assembled, this rank's rows, on the device) are prefetched two ahead (``device_batches``).
    Each step is a replay of captured CUDA graphs (train/step_graph.py), or eager where
    ``step_graph.eager_reason`` names why it cannot be captured (a mesh of several ranks: the
    mesh and pipeline trainers), which rank 0 prints.
    Over a ``mesh`` of several ranks every rank draws the same step batch and trains on its dp
    block of rows inside ``use_mesh``; rank 0 alone writes the run directory, its metrics, the
    profile and checkpoints."""
    from llama_x_tpu_torch.parallel.mesh import use_mesh
    from llama_x_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
    from llama_x_tpu_torch.train import step_graph
    from llama_x_tpu_torch.train.metrics import Profiler, RunLogger, Throughput, device_memory_stats
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

    mesh = mesh or make_mesh()
    lead = mesh.rank == 0
    if args.profile:
        args.n_steps = min(args.n_steps, 10)
    optimizer, schedule = setup_optimizer(args, model)
    state = TrainState(model, optimizer)
    eager = step_graph.eager_reason(model, mesh)
    if lead:
        print("train step: " + ("one replay of captured CUDA graphs a step" if eager is None else f"eager, since {eager}"))
    train_step = make_train_step(loss_fn, skip_nonfinite=args.skip_nonfinite, mesh=mesh, eager=eager is not None)
    if args.resume:
        path = latest_checkpoint(args.resume) or args.resume
        restore_checkpoint(path, state)
        print(f"resumed from {path} at step {state.step}")

    profiler = None
    if lead:
        save_dir = make_save_dir(task, args.run_name)
        save_model_config(save_dir, model.config, audio_config, vision_config)
        logger = RunLogger(save_dir, config=vars(args), project=args.project, run_name=args.run_name)
        if args.profile:
            profiler = Profiler(save_dir / "profile", model.device)

    def step_batches():
        while True:
            micro = [next(data_iter) for _ in range(args.gradient_accumulation)]
            yield shard_batch(assemble_step_batch(micro, pad_values={"labels": -100}), mesh)

    batch_iter = device_batches(step_batches(), model.device)
    meter = Throughput()
    tok_acc, audio_acc = 0, 0.0
    while state.step < args.n_steps:
        step = state.step
        batch = next(batch_iter)
        with use_mesh(mesh):
            metrics = train_step(state, batch)
        tok_acc = tok_acc + metrics["n_tokens"]
        audio_acc += audio_secs_per_step
        if lead and step % args.log_interval == 0:
            meter.update(int(tok_acc), audio_secs=audio_acc)
            tok_acc, audio_acc = 0, 0.0
            log = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(schedule(step)), **device_memory_stats(model.device)}
            if step > 0:
                log.update(meter.rates())
            logger.log(log, step)
            print(f"step {step}: loss {log['loss']:.4f}")
        if args.ckpt_interval > 0 and state.step % args.ckpt_interval == 0:
            save_checkpoint(save_dir if lead else None, state, state.step)
        if profiler is not None:
            profiler.step()

    if profiler is not None:
        profiler.close()
    save_checkpoint(save_dir if lead else None, state, state.step)
    if lead:
        logger.finish()
