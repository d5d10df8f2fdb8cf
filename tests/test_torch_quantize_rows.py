"""The rowwise quantizer's routing on the CPU: K7 (``ops/int8.py:quantize_rows``) is reached
only by CUDA tensors, the plain chain keeps every CPU call and stays bit for bit with the JAX
package's, K7's wrapper refuses what the kernel does not take, and its plan adapts its loads
and spans to the shape. K7 itself runs on the card (``tests/test_torch_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.ops import int8 as jint8
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.ops import int8 as i8
from llama_x_tpu_torch.parallel import mesh as tmesh


@pytest.fixture
def no_kernel(monkeypatch):
    """K7's entry point made to raise: a call that reaches it fails."""

    def refuse(*a, **k):
        raise AssertionError("K7 reached")

    monkeypatch.setattr(i8, "quantize_rows", refuse)


def _rows(dtype, R=6, C=40, seed=0):
    x = np.random.default_rng(seed).normal(size=(R, C)).astype(np.float32)
    x[0] = 0.0
    x[1, 3] = -9.0
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("col", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_cpu_tensor_takes_the_plain_chain(no_kernel, dtype, col):
    """On the CPU the codes and scales are the JAX package's for x, or for x * col_scale
    rounded to x's dtype (the backward's fold), bit for bit."""
    x = _rows(dtype)
    cs = torch.linspace(0.001, 0.05, x.shape[1]).to(dtype) if col else None
    q, s = i8.quantize_int8_rowwise(x, col_scale=cs)
    xs = x if cs is None else x * cs
    jq, js = jint8.quantize_int8_rowwise(jnp.asarray(xs.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                                                  else jnp.float32))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(js).astype(np.float32))
    assert s.dtype == dtype


def test_a_call_with_a_mesh_takes_the_plain_chain(no_kernel):
    """A mesh's call on the CPU keeps the plain chain, whose absmax is all-reduced before the
    rounding (a mesh of one rank: the whole row)."""
    x = _rows(torch.bfloat16)
    got = i8.quantize_int8_rowwise(x, tmesh.Mesh(tmesh.mesh_shape(1), 0, None), col_scale=torch.ones(40).to(x.dtype))
    want = i8.quantize_rows_plain(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_kv_rows_take_the_plain_chain(no_kernel):
    """The int8 cache's rows on the CPU: the plain chain, f32 scales of the leading shape."""
    x = _rows(torch.bfloat16, R=12, C=16).reshape(2, 3, 2, 16)
    q, s = llama.quantize_kv_rows(x)
    q_p, s_p = i8.quantize_rows_plain(x.reshape(-1, 16), scale_dtype=torch.float32)
    assert q.shape == x.shape and s.shape == (2, 3, 2) and s.dtype == torch.float32
    assert torch.equal(q.reshape(-1, 16), q_p) and torch.equal(s.reshape(-1), s_p)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_cpu_rows_of_every_dtype_take_the_plain_chain(no_kernel, dtype):
    """The CPU's rows never reach K7, in a dtype it takes or not; the scale is in x's dtype."""
    q, s = i8.quantize_int8_rowwise(_rows(dtype))
    q_p, s_p = i8.quantize_rows_plain(_rows(dtype))
    assert torch.equal(q, q_p) and torch.equal(s, s_p) and s.dtype == dtype


@pytest.mark.parametrize("case", ["float16", "one_dim", "three_dims", "no_columns", "strided_columns", "column_slice",
                                  "col_scale_dtype", "col_scale_length", "col_scale_strided", "bf16_scale_of_f32",
                                  "cpu"])
def test_the_wrapper_refuses_what_k7_does_not_take(case):
    """K7's wrapper raises on each thing the kernel does not take, before any launch (the
    last case, a CPU tensor that is otherwise right, fails on the device alone)."""
    x = torch.zeros(4, 32, dtype=torch.bfloat16)
    kw = {}
    err = ValueError
    if case == "float16":
        x, err = x.half(), TypeError
    elif case == "one_dim":
        x = x[0]
    elif case == "three_dims":
        x = x.reshape(2, 2, 32)
    elif case == "no_columns":
        x = x[:, :0]
    elif case == "strided_columns":
        x = x[:, ::2]
    elif case == "column_slice":
        x = x[:, :16]
    elif case == "col_scale_dtype":
        kw = dict(col_scale=torch.ones(32))
    elif case == "col_scale_length":
        kw = dict(col_scale=torch.ones(31, dtype=torch.bfloat16))
    elif case == "col_scale_strided":
        kw = dict(col_scale=torch.ones(64, dtype=torch.bfloat16)[::2])
    elif case == "bf16_scale_of_f32":
        x, kw, err = x.float(), dict(scale_dtype=torch.bfloat16), TypeError
    with pytest.raises(err):
        i8.quantize_rows(x, **kw)


@pytest.mark.parametrize("R,C,itemsize,aligned,plan", [
    (4096, 128, 2, True, (8, 3)),         # a prefill's KV cache rows (the kernel: a warp a row)
    (4096, 14336, 2, True, (8, 3)),       # w2's input: 1792 loads in 3 spans (the kernel: 256 threads)
    (512, 131072, 4, True, (4, 3)),       # the head's f32 dlogits: more loads than 3 spans hold
    (132, 4096, 2, True, (8, 3)),         # as many rows as SMs
    (131, 4096, 2, True, (8, 1)),         # fewer rows than SMs: every load in flight at once
    (32, 4096, 2, True, (8, 1)),          # decode
    (5, 37, 2, True, (1, 1)),             # no whole number of 16-byte loads
    (4096, 4096, 2, False, (1, 3)),       # an unaligned view
    (4096, 4100, 4, True, (4, 3)),        # f32 rows of whole 16-byte loads
    (4096, 4098, 4, True, (1, 3)),        # f32 rows that are not
])
def test_the_plan_adapts_its_loads_and_spans_to_the_shape(R, C, itemsize, aligned, plan):
    assert i8.quantize_rows_plan(R, C, itemsize, aligned) == plan


def test_k7_is_one_counted_kernel():
    """One counter, one kernel name family: a device trace's K7 records match its count."""
    from llama_x_tpu_torch.ops import launches

    assert launches.COUNTED["quantize_rows"] is i8.quantize_rows
    names = ["void (anonymous namespace)::quantize_rows_kernel<__nv_bfloat16, __nv_bfloat16, 8, 256>(...)",
             "void (anonymous namespace)::quantize_rows_kernel<float, float, 4, 32>(...)",
             "void at::native::reduce_kernel<512, 1>(...)"]
    assert launches.traced_counts(names)["quantize_rows"] == 2
