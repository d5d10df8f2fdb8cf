"""The four trainers under ``torch.distributed.run`` with slice 5b's meshes, against the same
command in one process, on the CPU: the text trainer at ``--mesh '{"tp": 2}'``,
``'{"fsdp": 2}'`` and ``'{"dp": 2, "pp": 2}' --pp_microbatches 2``, and the audio, vision and
omni trainers' pp branches (the stems outside the pipeline) at ``'{"pp": 2}'``. The losses as
the trainers print them (four decimals) agree to 2e-4, and rank 0 alone writes the run."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
SMALL = '{"num_layers": 2, "embed_dim": 64, "head_dim": 16, "num_heads": 4, "num_kv_heads": 2, "intermediate_dim": 128}'
TEXT = ["llama_x_tpu_torch.train_metamathqa", "--synthetic", "16", "--batch_size", "4", "--document_mask",
        "--max_seq_len", "128"]
AUDIO = ["llama_x_tpu_torch.train_librispeech", "--synthetic", "8", "--batch_size", "2", "--audio_duration", "1",
         "--seq_len_multiple", "16", "--prefix_lm"]
VISION = ["llama_x_tpu_torch.train_vision", "--synthetic", "8", "--batch_size", "2", "--image_size", "32",
          "--patch_size", "8", "--prefix_lm"]
OMNI = ["llama_x_tpu_torch.train_omni", "--synthetic", "8", "--batch_size", "2", "--audio_duration", "1",
        "--image_size", "32", "--patch_size", "8", "--seq_len_multiple", "16", "--max_text_len", "16", "--prefix_lm"]
COMMON = ["--device", "cpu", "--n_steps", "2", "--log_interval", "1", "--ckpt_interval", "0", "--dtype", "float32",
          "--synthetic_config", SMALL]


def _losses(out: str) -> list[float]:
    return [float(x) for x in re.findall(r"step \d+: loss (\S+)", out)]


def _run(tmp_path, argv, nproc: int = 1) -> list[float]:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc)]
              if nproc > 1 else [sys.executable])
    out = subprocess.run([*launch, "-m", *argv, *COMMON], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    losses = _losses(out.stdout)
    assert len(losses) == 2, out.stdout[-2000:]
    return losses


@pytest.mark.parametrize("argv,meshes", [
    (TEXT, [('{"tp": 2}', 2, []), ('{"fsdp": 2}', 2, []), ('{"dp": 2, "pp": 2}', 4, ["--pp_microbatches", "2"])]),
    (AUDIO, [('{"pp": 2}', 2, ["--pp_microbatches", "2"])]),
    (VISION, [('{"pp": 2}', 2, ["--pp_microbatches", "2"])]),
    (OMNI, [('{"pp": 2}', 2, ["--pp_microbatches", "2"])]),
])
def test_trainer_under_torchrun_with_5b_meshes_matches_one_process(tmp_path, argv, meshes):
    (tmp_path / "one").mkdir()
    want = _run(tmp_path / "one", argv)
    for i, (mesh, n, extra) in enumerate(meshes):
        d = tmp_path / f"mesh{i}"
        d.mkdir()
        got = _run(d, [*argv, "--mesh", mesh, *extra], n)
        np.testing.assert_allclose(got, want, atol=2e-4, err_msg=mesh)
        task = next((d / "runs").iterdir())
        assert len(list(task.iterdir())) == 1  # rank 0 alone wrote its run
