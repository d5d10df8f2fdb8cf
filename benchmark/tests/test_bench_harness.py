"""The harness: BENCHMARK.json against the contract's form, the files each name points to,
a cell added as data alone, the traffic kinds' determinism, a CPU dry run that loads no
JAX, and the refusal to measure without a card."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import spec as spec_mod
from benchmark.run import run_cell
from benchmark.tests.tiny import CELLS, CONFIG, MIXES, make_root
from benchmark.traffic import chat_sessions, offline_batch, packed_sft

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_names_units_and_lines():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names)), group
        for x in BENCH[group]:
            assert spec_mod.NAME.match(x["name"]), x["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec_mod.UNIT.match(m["unit"]) and len(m["unit"]) <= 16, m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(spec_mod.NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert LINE.match(w["why"]) and spec_mod.NAME.match(w["traffic"])
    assert all(LINE.match(word) for word in BENCH["command"])


def test_every_name_points_to_its_files():
    spec = spec_mod.Spec(ROOT)
    for c in BENCH["configs"]:
        cfg = spec.config(c["name"])
        assert set(c["reduced"]) <= set(json.loads((ROOT / c["file"]).read_text())["reduced"])
        assert cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        assert spec_mod.kind(spec.mix(cell["traffic"])["kind"])
        assert cell["limits"]


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    spec = spec_mod.Spec(ROOT)
    for m in BENCH["per_layer"]:
        reader = spec.reader(m["name"])
        declared = (reader.UNIT, reader.MOVES, reader.SOURCE, reader.LAYER)
        assert declared == (m["unit"], m["moves"], m["source"], m["layer"])
        assert LINE.match(m["layer"])
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in spec.end_to_end(cell)}, (m["name"], cell)
            assert m in spec.per_layer(cell)
    for cell in spec.cells:
        names = {e["name"] for e in spec.end_to_end(cell)}
        assert "setup_s" in names and len(names) >= 2 and spec.per_layer(cell)


def test_a_cell_added_as_data_is_found(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="tiny-train-2", config="tiny", traffic="tiny_sft_2", chips=1, why="added"))
    next(m for m in bench["end_to_end"] if m["name"] == "train_tokens_per_s")["workloads"].append("tiny-train-2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark/traffic/tiny_sft_2.json").write_text(json.dumps(dict(MIXES["tiny_sft"], doc_median=12)))
    (root / "benchmark/workloads/tiny-train-2.json").write_text(
        json.dumps(dict(CELLS["tiny-train"], traffic="tiny_sft_2")))
    result = run_cell(root, "tiny-train-2", 7, 0.5, False, "cpu", log=lambda msg: None)
    assert result["correct"] and set(result["metrics"]) == {"setup_s", "train_tokens_per_s"}


def _same(a, b) -> bool:
    return json.dumps(a, default=lambda x: x.tolist()) == json.dumps(b, default=lambda x: x.tolist())


@pytest.mark.parametrize("kind, mix, n", [(packed_sft, "tiny_sft", 2), (chat_sessions, "tiny_chat", 20.0),
                                          (offline_batch, "tiny_batch", 2)])
def test_traffic_is_made_from_the_seed(kind, mix, n):
    big = 2**31 + 12345
    one, again, other = (kind.generate(MIXES[mix], CONFIG, seed, n) for seed in (big, big, big + 1))
    assert _same(one, again) and not _same(one, other)


def test_every_seed_offers_the_same_work():
    """The chat schedule (arrivals, lengths) is the mix's, the same for every seed; the
    training steps draw the same set of document lengths in another order."""
    def shape(seed):
        return [(r["due"], len(r["prompt"]), r["max_tokens"], r["session"])
                for r in chat_sessions.generate(MIXES["tiny_chat"], CONFIG, seed, 20.0)]
    assert shape(1) == shape(2**31 + 5)
    lengths, mix = set(packed_sft.doc_lengths(MIXES["tiny_sft"])), MIXES["tiny_sft"]
    rows = [packed_sft.step_batch(mix, 256, seed, 0)["docs"] for seed in (1, 2)]
    assert rows[0] != rows[1]
    for row in rows[0] + rows[1]:
        # full rows of the quantile lengths; the last document cut to fit (the one before it
        # may take a one-position remainder)
        assert sum(row) == mix["seq_len"] and set(row[:-2]) <= lengths


def test_dry_run_loads_no_jax(tmp_path):
    make_root(tmp_path)
    code = ("import sys, json; from pathlib import Path; from benchmark.run import run_cell; "
            f"[run_cell(Path({str(tmp_path)!r}), c, 5, 0.5, t, 'cpu', log=lambda m: None) "
            "for c, t in (('tiny-train', True), ('tiny-chat', False))]; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "llama_x_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "llama_x_tpu"}


def test_no_card_no_result():
    """On a machine without the card a measured run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "m7b-int8-chat", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_outside_a_checkout_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files (no program)."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "m7b-int8-chat", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.gpu
def test_chat_cell_on_the_card():
    """A short run of the chat cell on the card: correct, and its end-to-end metrics."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "m7b-int8-chat", "--seed", "11",
                          "--seconds", "5", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"ttft_p95_ms", "tpot_p95_ms", "serve_tokens_per_s", "setup_s"}
