"""The trainer pieces of the port on the CPU: ``train/cli.py:prefetch`` and
``device_batches`` (the step batches drawn on a background thread, in order, a loader's
exception raised in the consumer), ``train/metrics.py:Profiler`` (a trace of steps 5 and 6),
the MetaMathQA token cache (``data/metamathqa.py``, keyed by tokenizer and length),
``train_metamathqa`` on real data from a cache and its refusal without one,
``generate_cli --template alpaca``, and the flags accepted for the JAX trainers' sake
(``--project``, ``train_librispeech --n_workers``)."""

import json
import threading

import numpy as np
import pytest
import torch

from llama_x_tpu.data import metamathqa as jdata
from llama_x_tpu_torch.data import metamathqa as tdata
from llama_x_tpu_torch.train import cli as tcli

SMALL = ["--synthetic_config", '{"num_layers": 2, "embed_dim": 64, "head_dim": 16, "num_heads": 4, "num_kv_heads": 2, '
         '"intermediate_dim": 128}']


def _records(n: int = 24):
    return [{"query": f"What is {i} + {i}?", "response": f"{i} + {i} = {2 * i}. The answer is: {2 * i}"}
            for i in range(n)]


def test_prefetch_yields_the_inline_batches_in_order():
    """The step batches of the trainers' pipeline (accumulation, assembly), drawn on the
    thread: the same arrays in the same order as drawn inline, then the end."""
    toks = [np.arange(3 + i % 5, dtype=np.int32) for i in range(40)]

    def step_batches():
        it, _ = tdata.get_metamathqa("byte", False, 2, 64, 8, tokens_list=toks, seed=1)
        for _ in range(6):
            yield tcli.assemble_step_batch([next(it) for _ in range(2)], pad_values={"labels": -100})

    got = list(tcli.prefetch(step_batches(), depth=2))
    want = list(step_batches())
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    on_device = list(tcli.device_batches(step_batches(), "cpu"))
    for g, w in zip(on_device, want):
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_prefetch_raises_a_loader_exception_in_the_consumer():
    def loader():
        yield {"x": np.zeros(2)}
        raise OSError("the loader broke")

    it = tcli.prefetch(loader())
    assert next(it)["x"].shape == (2,)
    done = threading.Event()
    caught = []

    def consume():
        try:
            next(it)
        except OSError as e:
            caught.append(e)
        done.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    assert done.wait(timeout=30)
    t.join(timeout=5)
    assert not t.is_alive()
    assert [str(e) for e in caught] == ["the loader broke"]


def test_profiler_traces_steps_five_and_six(tmp_path):
    """The schedule wait 1, warmup 4, active 2: after seven steps the CPU trace holds the ops
    of steps 5 and 6 only."""
    from llama_x_tpu_torch.train.metrics import Profiler

    prof = Profiler(tmp_path / "profile", "cpu")
    for step in range(7):
        with torch.profiler.record_function(f"step_{step}"):
            torch.ones(4).sum()
        prof.step()
    prof.close()
    (trace,) = (tmp_path / "profile").glob("*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"step_5", "step_6"} <= names
    assert not names & {f"step_{i}" for i in range(5)}


def test_tokenize_cache_key_includes_seq_len(tmp_path):
    """The port of tests/test_review_fixes.py's case: each length has its own cache."""
    class FakeTok:
        def __call__(self, text, add_bos=False, add_eos=False):
            return list(range(40))

    for msl in (8, 16):
        flat = np.arange(msl + 1, dtype=np.int32)
        offsets = np.asarray([0, msl + 1], np.int64)
        np.savez(tmp_path / f"metamathqa_fake_s{msl}.npz", flat=flat, offsets=offsets)
        out = tdata.tokenize_metamathqa(FakeTok(), "fake", msl, cache_dir=str(tmp_path))
        assert len(out[0]) == msl + 1


def test_token_cache_is_written_as_the_jax_package_reads_it(tmp_path):
    """Records tokenized into the cache (prompt template + answer, truncated to
    max_seq_len + 1) read back by the port and by the JAX package alike; no temporary file
    is left."""
    from llama_x_tpu_torch.data.tokenizers import get_tokenizer

    tok = get_tokenizer("byte")
    got = tdata.tokenize_metamathqa(tok, "byte", 96, tmp_path, records=_records())
    assert [p.name for p in tmp_path.iterdir()] == ["metamathqa_byte_s96.npz"]
    first = tok(tdata.PROMPT_TEMPLATE.format(query="What is 0 + 0?"), add_bos=True)
    np.testing.assert_array_equal(got[0], np.asarray(first[:97], np.int32))
    assert all(len(t) <= 97 for t in got)
    back = tdata.tokenize_metamathqa(None, "byte", 96, tmp_path)
    jback = jdata.tokenize_metamathqa(None, "byte", 96, str(tmp_path))
    assert tdata.PROMPT_TEMPLATE == jdata.PROMPT_TEMPLATE
    for a, b, c in zip(got, back, jback):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_train_metamathqa_reads_the_token_cache(tmp_path, monkeypatch):
    """Without --synthetic the text trainer trains from the cache in the working directory
    (with --profile, --project and the prefetched step batches) and, without one, raises
    naming the file."""
    from llama_x_tpu_torch import train_metamathqa as entry
    from llama_x_tpu_torch.data.tokenizers import get_tokenizer

    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--max_seq_len", "128", "--n_steps", "12", "--batch_size", "2", "--document_mask",
            "--log_interval", "1", "--ckpt_interval", "0", "--lr", "3e-3", "--profile", "--project", "p", *SMALL]
    with pytest.raises(FileNotFoundError, match="metamathqa_byte_s128.npz"):
        entry.main(argv)
    tdata.tokenize_metamathqa(get_tokenizer("byte"), "byte", 128, tmp_path, records=_records())
    entry.main(argv)
    (run,) = (tmp_path / "runs" / "metamathqa").iterdir()
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == list(range(10))  # --profile stops the run after 10 steps
    assert recs[-1]["loss"] < recs[0]["loss"]
    assert len(list((run / "profile").glob("*.json"))) == 1
    assert json.loads((run / "config.json").read_text())["project"] == "p"


def test_generate_cli_alpaca_template(capsys):
    from llama_x_tpu_torch import generate_cli
    from llama_x_tpu_torch.data.metamathqa import PROMPT_TEMPLATE

    generate_cli.main(["--geometry", "tiny", "--device", "cpu", "--prompt", "2+2?", "--max_new_tokens", "2",
                       "--max_seq_len", "256", "--template", "alpaca"])
    assert PROMPT_TEMPLATE.format(query="2+2?") in capsys.readouterr().out


def test_project_and_n_workers_are_accepted():
    from llama_x_tpu_torch import train_librispeech

    args = train_librispeech.parse_args(["--synthetic", "4", "--n_workers", "8", "--project", "p", "--device", "cpu"])
    assert (args.n_workers, args.project, args.profile) == (8, "p", False)
