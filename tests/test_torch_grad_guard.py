"""No gradient is lost silently at a kernel wrapper that has no backward.

On the card the attention forward kernel and the selective-scan kernel
write their outputs through raw pointers, so an output has no
``grad_fn``: each wrapper raises when autograd would record (grad
enabled and an operand that requires grad), and the model's attention
routes differentiable calls through the backward kernels at every (D,
Dv) pair of the kernel, multi-head latent attention's (192, 128) and (24,
16) included, and raises where there is none (a window).  These checks
come before the device check, so meta tensors show them on the CPU (the
kernel wrappers replaced by recorders of what they are handed);
``tests/test_torch_cuda.py`` shows them on the card.  The CPU
paths (the plain versions) stay differentiable, and the backward's plain
version equals autograd through the chunked attention.
"""
import pytest
import torch

from repro_torch.kernels import flash_attn, flash_attn_bwd, ssm_scan
from repro_torch.models import attention


def _meta(*shape, grad=True):
    return torch.empty(*shape, device="meta", requires_grad=grad)


def test_attention_kernel_refuses_a_gradient():
    q = _meta(1, 4, 16, 64)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attn.flash_attention(q, q, q)
    with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
        flash_attn.flash_attention(q, q, q)          # past the guard


def test_scan_kernel_refuses_a_gradient():
    x = _meta(1, 8, 32)
    ops = (x, x, _meta(1, 8, 16, grad=False), _meta(1, 8, 16, grad=False),
           _meta(32, 16, grad=False), _meta(32, grad=False),
           _meta(1, 32, 16, grad=False))
    with pytest.raises(RuntimeError, match="no backward"):
        ssm_scan.ssm_scan(*ops)
    with torch.inference_mode(), pytest.raises(ValueError, match="cuda"):
        ssm_scan.ssm_scan(*ops)                      # past the guard


@pytest.mark.parametrize("d,dv,window,match", [(64, 64, 16, "window")])
def test_model_attention_refuses_a_gradient_without_a_backward(d, dv, window,
                                                              match):
    q, v = _meta(1, 16, 4, d), _meta(1, 16, 4, dv)
    with pytest.raises(ValueError, match=match):
        attention.flash_attention(q, q, v, window=window)


@pytest.mark.parametrize("d,dv", [(192, 128), (24, 16), (128, 128)])
def test_model_attention_routes_pairs_through_the_kernels(monkeypatch, d,
                                                          dv):
    """Under autograd every pair of the kernel, multi-head latent
    attention's (192, 128) and (24, 16) included, goes through
    ``_KernelAttention``: the forward kernel writes a (B, H, S, Dv) view
    of a (B, S, H, Dv) output beside the (B, H, S) lse, and the backward
    kernels get the output and its gradient at width Dv and write dq and
    dk at D, dv at Dv."""
    seen = {}

    def fwd(q, k, v, *, causal, scale, out, lse):
        seen["fwd"] = (tuple(out.shape), tuple(lse.shape), scale)
        return out

    def bwd(q, k, v, out, dout, lse, *, causal, scale, dq, dk, dv):
        seen["bwd"] = [tuple(t.shape) for t in (out, dout, dq, dk, dv)]
        return dq, dk, dv

    monkeypatch.setattr(flash_attn, "flash_attention", fwd)
    monkeypatch.setattr(flash_attn_bwd, "flash_attention_bwd", bwd)
    q, k, v = _meta(2, 16, 4, d), _meta(2, 16, 4, d), _meta(2, 16, 4, dv)
    out = attention.flash_attention(q, k, v, scale=0.3)
    assert type(out.grad_fn).__name__ == "_KernelAttentionBackward"
    assert tuple(out.shape) == (2, 16, 4, dv)
    assert seen["fwd"] == ((2, 4, 16, dv), (2, 4, 16), 0.3)
    grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert seen["bwd"] == [(2, 4, 16, dv)] * 2 + [(2, 4, 16, d)] * 2 \
        + [(2, 4, 16, dv)]
    assert [tuple(g.shape) for g in grads] == [(2, 16, 4, d)] * 2 \
        + [(2, 16, 4, dv)]


def test_backward_refuses_before_any_launch():
    x = torch.zeros(1, 2, 8, 64)
    lse = torch.zeros(1, 2, 8)
    before = flash_attn_bwd.LAUNCHES
    with pytest.raises(ValueError, match="window"):
        flash_attn_bwd.flash_attention_bwd(x, x, x, x, x, lse, window=4)
    with pytest.raises(ValueError, match="64, 32"):
        flash_attn_bwd.flash_attention_bwd(x, x, x[..., :32], x, x, lse)
    assert flash_attn_bwd.LAUNCHES == before


@pytest.mark.parametrize("causal", [True, False])
def test_cpu_paths_stay_differentiable(causal):
    """On the CPU the model's attention is the chunked algorithm under
    autograd, and the backward wrapper's plain version (autograd through
    the float32 reference) gives its gradients to float32 rounding."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 64, hh, 16, generator=gen, requires_grad=True)
               for hh in (8, 2, 2))
    do = torch.randn(2, 64, 8, 16, generator=gen)
    out = attention.flash_attention(q, k, v, causal=causal, chunk=32)
    assert out.grad_fn is not None
    want = torch.autograd.grad(out, (q, k, v), do)
    got = flash_attn_bwd.flash_attention_bwd(
        *(t.detach().transpose(1, 2) for t in (q, k, v)),
        out.detach().transpose(1, 2), do.transpose(1, 2),
        torch.zeros(2, 8, 64), causal=causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.transpose(1, 2), w, rtol=1e-5,
                                   atol=1e-5)
