"""Serving under tensor parallelism (slice 5b), against the JAX package on the CPU: the three
cases of tests/test_multichip_serving.py with the port's model sharded by ``shard_params``
(every rank holds its heads' KV cache, the vocabulary-sharded logits are gathered whole
before sampling, and all ranks emit the same tokens):

- ``generate`` with an int8 KV cache at tp 2;
- greedy speculative decoding at tp 2 (target and draft sharded), equal to plain greedy;
- the continuous scheduler's cycle (admission, a chunked prefill of 8 + 8, install, 7
  decode steps) at dp 2 x tp 2.

The JAX test shards over tp 4; the port's tp must divide the kv heads (2 in this
geometry, as ``validate_model`` and ``shard_params`` require), so it runs tp 2. Tokens are
held identical (fp32) to the port's unsharded run and to the JAX package's. Also the port's
two-process ``dryrun_multihost`` against a single process (tests/test_multihost.py)."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.models import llama as jllama
from llama_x_tpu.models.generate import generate as jgenerate
from llama_x_tpu.models.speculative import generate_speculative as jgenerate_speculative
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import params_from_jax
from llama_x_tpu_torch.models.generate import generate as tgenerate
from torch_dist_workers import run_ranks

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(max_seq_len=128)
DRAFT = dict(max_seq_len=128, num_layers=2)


@pytest.fixture(scope="module")
def setup():
    cfg = jllama.tiny_config(attn_impl="xla", **CFG)
    params = jllama.init(jax.random.PRNGKey(5), cfg, dtype=jnp.float32)
    dcfg = jllama.tiny_config(attn_impl="xla", **DRAFT)
    dparams = jllama.init(jax.random.PRNGKey(6), dcfg, dtype=jnp.float32)
    prompt = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    return cfg, params, dcfg, dparams, prompt


@pytest.fixture(scope="module")
def served(setup, tmp_path_factory):
    """Each mesh's ranks' tokens: tp 2 in two processes, dp 2 x tp 2 in four."""
    _, params, _, dparams, prompt = setup
    job = dict(kind="serve", params=jax.tree.map(np.asarray, params), config=CFG, freeze=(),
               draft_params=jax.tree.map(np.asarray, dparams), draft_config=DRAFT, prompt=prompt)
    return {"tp": run_ranks(dict(job, world=2, mesh=dict(tp=2)), tmp_path_factory.mktemp("tp")),
            "dp_tp": run_ranks(dict(job, world=4, mesh=dict(dp=2, tp=2)), tmp_path_factory.mktemp("dptp"))}


def _port(params, cfg):
    return params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(**cfg), device="cpu")


def test_tp_int8_kv_decode_matches_single_device(setup, served):
    cfg, params, _, _, prompt = setup
    want = np.asarray(jgenerate(params, cfg, jnp.asarray(prompt), max_new_tokens=8, cache_dtype=jnp.int8))
    one = tgenerate(_port(params, CFG), torch.from_numpy(prompt).long(), max_new_tokens=8, cache_dtype=torch.int8)
    np.testing.assert_array_equal(one.numpy(), want)
    for r in served["tp"] + served["dp_tp"]:
        np.testing.assert_array_equal(r["generate"], want)


def test_tp_speculative_matches_single_device_and_target_greedy(setup, served):
    from llama_x_tpu_torch.models.speculative import generate_speculative as tspec

    cfg, params, dcfg, dparams, prompt = setup
    want, _ = jgenerate_speculative(params, cfg, dparams, dcfg, jnp.asarray(prompt), max_new_tokens=8, gamma=3)
    greedy = np.asarray(jgenerate(params, cfg, jnp.asarray(prompt), max_new_tokens=8))
    np.testing.assert_array_equal(np.asarray(want), greedy)
    one, _ = tspec(_port(params, CFG), _port(dparams, DRAFT), torch.from_numpy(prompt).long(), max_new_tokens=8,
                   gamma=3, cache_dtype=torch.float32)
    np.testing.assert_array_equal(one.numpy(), greedy)
    for r in served["tp"] + served["dp_tp"]:
        np.testing.assert_array_equal(r["speculative"], greedy)


def test_dp_tp_continuous_cycle_matches_unbatched_generate(setup, served):
    cfg, params, _, _, prompt = setup
    want = np.asarray(jgenerate(params, cfg, jnp.asarray(prompt), max_new_tokens=8))
    for r in served["dp_tp"] + served["tp"]:
        np.testing.assert_array_equal(r["continuous"], want)


def test_two_process_dryrun_matches_single_process():
    out = subprocess.run([sys.executable, "-m", "llama_x_tpu_torch.dryrun_multihost", "--device", "cpu"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "dryrun_multihost OK" in out.stdout, out.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine without a card")
def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu():
    from llama_x_tpu_torch import dryrun_multihost

    with pytest.raises(RuntimeError, match="CUDA device by default"):
        dryrun_multihost.main([])
