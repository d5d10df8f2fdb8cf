"""The plain reference against the port's CPU path at a tiny size, over the same drawn
inputs: the QLoRA loss and LoRA gradients under a document mask, and the logits of a
served sequence; and the reference's isolation from JAX and from the program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import port, weights
from benchmark.reference import model as ref
from benchmark.tests.tiny import CONFIG, MIXES
from benchmark.traffic import packed_sft

CFG = dict(CONFIG, name="tiny")
BITS = dict(act=8, grad=8, head=8, lora_scale=1.0)


def fp32(tensors):
    """The drawn inputs with their float tensors widened, so that the port computes in float32
    as the reference does and only the order of sums differs."""
    return {k: v.float() if v.is_floating_point() and not k.endswith(".scale") else v for k, v in tensors.items()}


def test_training_loss_and_lora_gradients():
    tensors = fp32(weights.draw(CFG, 1234, "cpu", lora_rank=4))
    model = port.build(CFG, tensors, dict(fused_ce_chunks=2, dynamic_int8_act=True, dynamic_int8_bwd=True,
                                           int8_head=True), lora_scale=1.0)
    b = packed_sft.step_batch(MIXES["tiny_sft"], CFG["vocab_size"], 99, 0)
    tokens, labels, seg = (torch.from_numpy(b[k][0]).long() for k in ("inputs", "labels", "segment_ids"))
    from llama_x_tpu_torch.models import llama

    loss = llama.forward(model, tokens, segment_ids=seg, labels=labels)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for p in model.parameters() if p.requires_grad])
    r_loss, r_grads = ref.loss_and_grads(CFG, ref.Weights(CFG, tensors), tokens[0], labels[0], b["docs"][0], BITS)
    assert float(loss.detach()) == pytest.approx(r_loss, rel=1e-5)
    for n, g in zip(names, grads):
        r = r_grads[packed_sft._leaf(n)]
        # an int8 rounding that flips between the two orders of summation moves a row by one
        # code: a few thousandths of a leaf's norm
        assert float((g - r).norm()) <= 1e-2 * float(r.norm()) + 1e-7, n


def test_served_logits():
    tensors = fp32(weights.draw(CFG, 4321, "cpu"))
    model = port.build(CFG, tensors, dict(dynamic_int8_act=True))
    seq = torch.from_numpy(np.random.default_rng(5).integers(0, CFG["vocab_size"], 40))
    from llama_x_tpu_torch.models import llama

    with torch.no_grad():
        lp = llama.forward(model, seq[None])[0]
    at = torch.arange(len(seq))
    lr = ref.logits(CFG, ref.Weights(CFG, tensors), seq, at, dict(act=8, grad=None, kv=None))
    assert float((lp - lr).abs().max()) <= 1e-3 * float(lr.abs().max())
    assert torch.equal(lp.argmax(-1), lr.argmax(-1))


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys, benchmark.reference.model, benchmark.weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    names = set(eval(out))
    assert not names & {"jax", "jaxlib", "flax", "llama_x_tpu", "llama_x_tpu_torch"}, names & {"jax", "llama_x_tpu"}
