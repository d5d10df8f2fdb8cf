"""Launch-time validation: refuse unsupported flag / mesh / config combinations before any
model is built (port of llama_x_tpu/train/validate.py).

Every trainer calls ``validate_launch`` right after it has its mesh, and ``validate_model``
once the model config exists; each refusal names the flag to change. The checks and the
messages are the JAX package's. Its refusal of ``--attn_impl flash`` off a TPU has no
counterpart: the port's flash path is the kernels on the card and their plain versions on
the CPU. ``mesh`` is anything with a ``shape`` dict over the axes (parallel/mesh.py: Mesh).
"""

from __future__ import annotations

from llama_x_tpu_torch.parallel.ulysses import _kv_repeat


class LaunchConfigError(ValueError):
    """An unsupported flag / mesh / model combination, detected before the model is built."""


def _err(msg: str):
    raise LaunchConfigError(msg)


def validate_launch(args, mesh, *, modality: str = "text", max_seq_len: int | None = None):
    """Argument-time checks: flags against the mesh. ``modality`` is the trainer's prefix
    modality ("text" | "audio" | "vision" | "omni")."""
    if args.batch_size % args.gradient_accumulation != 0:
        _err(
            f"--batch_size {args.batch_size} must divide by --gradient_accumulation "
            f"{args.gradient_accumulation}"
        )

    cp = mesh.shape.get("cp", 1)
    pp = mesh.shape.get("pp", 1)
    dp_size = mesh.shape.get("dp", 1) * mesh.shape.get("fsdp", 1)
    micro_bs = args.batch_size // max(args.gradient_accumulation, 1)
    if micro_bs % dp_size != 0:
        _err(
            f"per-accumulation batch {micro_bs} (--batch_size {args.batch_size} / "
            f"--gradient_accumulation {args.gradient_accumulation}) must divide by the "
            f"data-parallel mesh size dp*fsdp={dp_size}"
        )

    if args.attn_impl in ("ring", "ulysses"):
        if cp <= 1:
            _err(
                f'--attn_impl {args.attn_impl} needs a context-parallel mesh axis: pass e.g. '
                f'--mesh \'{{"cp": 2, ...}}\' ({args.attn_impl} attention shards the sequence over "cp")'
            )
        if max_seq_len is not None and max_seq_len % cp != 0:
            _err(f"max_seq_len {max_seq_len} must divide by the cp axis ({cp}) for {args.attn_impl} attention")
        if pp > 1:
            _err(f"--attn_impl {args.attn_impl} cannot combine with a pp mesh axis (its shard_map cannot nest inside pipeline stages)")
    elif cp > 1:
        _err('a "cp" mesh axis requires --attn_impl ring or ulysses (other attention paths never shard the sequence)')


def validate_model(config, mesh, args, *, modality: str = "text"):
    """Model-config checks (the config exists, nothing is built yet)."""
    cp = mesh.shape.get("cp", 1)
    pp = mesh.shape.get("pp", 1)

    if args.attn_impl in ("ring", "ulysses"):
        if config.attn_dropout > 0.0:
            _err(
                f"attention dropout ({config.attn_dropout}) is not supported with "
                f"--attn_impl {args.attn_impl} (no per-shard PRNG plumbing); drop the "
                "dropout or use --attn_impl flash"
            )
        if config.max_seq_len % cp != 0:
            _err(f"max_seq_len {config.max_seq_len} must divide by the cp axis ({cp})")

    if args.attn_impl == "ulysses":
        if config.num_heads % cp != 0:
            _err(
                f"num_heads {config.num_heads} must divide by the cp axis ({cp}) for "
                "--attn_impl ulysses (head-scatter); use --attn_impl ring instead"
            )
        if _kv_repeat(config.num_heads, config.num_kv_heads, cp) is None:
            _err(
                f"GQA geometry Hq={config.num_heads}/Hkv={config.num_kv_heads} cannot be "
                f"head-scattered over cp={cp} (needs num_heads % lcm(num_kv_heads, cp) == 0); "
                "use --attn_impl ring instead"
            )

    if pp > 1:
        if config.num_layers % pp != 0:
            _err(f"num_layers {config.num_layers} must divide by the pp axis ({pp})")
        if config.attn_dropout > 0.0:
            _err("attention dropout with pipeline parallelism is not supported yet (no per-stage rng plumbing); set attn_dropout=0")

    if config.fused_ce_chunks < 0:
        _err(f"--fused_ce_chunks must be >= 0, got {config.fused_ce_chunks}")

    tp = mesh.shape.get("tp", 1)
    if tp > 1 and (config.num_kv_heads % tp != 0):
        _err(f"num_kv_heads {config.num_kv_heads} must divide by the tp axis ({tp}) for head-sharded attention")
