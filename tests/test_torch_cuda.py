"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a GPU every test skips with the reason.
This file imports only ``torch`` and ``repro_torch`` (no JAX), so it
runs on a GPU machine that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

float32 rtol/atol 2e-3; the launch counts show the kernels ran.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import codegen_cuda as cc
from repro_torch.core import ir
from repro_torch.core import pipeline as pl
from repro_torch.core.dse import PipelinePlan
from repro_torch.core.strip_mine import tile
from repro_torch.patterns import analytics as an

NAMES = sorted(an.PIPELINES)
TOL = dict(rtol=2e-3, atol=2e-3)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_fused_dag_kernel_matches_plain_and_reference(name):
    _card()
    pipe, make_inputs, reference = an.PIPELINES[name](n=65536)
    host = make_inputs()
    inp = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    before = cc.fused_dag.launches
    kern = cc.lower_fused_pipeline(pipe)
    out = kern(**inp)
    torch.cuda.synchronize()
    assert cc.fused_dag.launches == before + len(kern.pipeline_plan.groups)
    assert all(how == "megakernel" for _, how in kern.group_lowerings)
    names = pl.output_names(pipe)
    out = out if isinstance(out, dict) else {names[0]: out}
    ref = reference(host)
    ref = ref if isinstance(ref, dict) else {names[0]: ref}
    plain = cc.fused_dag_plain(kern.group_calls[0].kernel.spec, inp)
    for k in out:
        assert out[k].is_cuda
        torch.testing.assert_close(out[k], plain[k], **TOL)
        np.testing.assert_allclose(out[k].cpu().numpy(), ref[k], **TOL)


@pytest.mark.cuda
def test_fused_dag_cam_drops_out_of_range_keys():
    _card()
    n, k = 4096, 4
    pipe, make_inputs, reference = an.PIPELINES["gda_moments"](n=n, k=k)
    host = make_inputs()
    host["labels"][:64] = np.linspace(-8, 8, 64).astype(np.float32)
    inp = {k_: torch.as_tensor(v).cuda() for k_, v in host.items()}
    out = cc.lower_fused_pipeline(pipe)(**inp)
    ref = reference(host)
    for name in ref:
        np.testing.assert_allclose(out[name].cpu().numpy(), ref[name], **TOL)


@pytest.mark.cuda
def test_tiled_gemm_kernel_matches_plain():
    _card()
    p, sizes, make_inputs, reference = an.gemm(256, 256, 512)
    host = make_inputs()
    inp = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    before = cc.tiled_gemm.launches
    out = cc.lower(tile(p, sizes))(**inp)
    assert cc.tiled_gemm.launches == before + 1
    plain = cc.tiled_gemm_plain(inp["x"], inp["y"], bm=64, bn=64, bk=64)
    torch.testing.assert_close(out, plain, **TOL)
    np.testing.assert_allclose(out.cpu().numpy(), reference(host), **TOL)


@pytest.mark.cuda
def test_kernel_refuses_a_plan_beyond_the_cards_shared_memory():
    _card()
    # 4 tiles x 16384 words x 4 slots: 1 MiB of shared memory
    pipe, make_inputs, _ = an.PIPELINES["tpchq6"](n=65536)
    plan = {"block": 16384, "groups": [[0, 2]], "group_blocks": [16384],
            "depths": [4], "traffic_words": 0, "unfused_traffic_words": 0,
            "vmem_bytes": 0, "modeled_seconds": 0.0}
    kern = cc.lower_fused_pipeline(pipe, plan=PipelinePlan.from_json(plan))
    assert kern.group_lowerings == (("q6_sum", "megakernel"),)
    inp = {k: torch.as_tensor(v).cuda() for k, v in make_inputs().items()}
    with pytest.raises(ValueError, match="shared memory"):
        kern(**inp)


@pytest.mark.cuda
def test_group_without_a_megakernel_raises_on_the_card():
    _card()
    n = 256
    x = ir.Tensor("x", (n,))
    sq = ir.Map(domain=(n,), reads=(ir.elem(x),), fn=lambda s, e: e * e,
                cuda="out[0] = in0[0] * in0[0];", name="sq")
    top = ir.MultiFold(
        domain=(n,), range_shape=(), init=lambda: torch.tensor(0.0),
        reads=(ir.elem(ir.Tensor("sq", (n,))),),
        out_index_map=lambda i: (), update_shape=(),
        fn=lambda s, acc, v: torch.maximum(acc, v), combine=torch.maximum,
        cuda="out[0] = in0[0];", name="top")
    pipe = pl.Pipeline(name="max", stages=(sq, top))
    with pytest.raises(NotImplementedError, match="'max' has no CUDA"):
        cc.lower_fused_pipeline(pipe)
