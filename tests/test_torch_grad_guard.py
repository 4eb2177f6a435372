"""No gradient is lost silently at a kernel wrapper that has no backward.

On the card the attention forward kernel and the selective-scan kernel
write their outputs through raw pointers, so an output has no
``grad_fn``: each wrapper raises when autograd would record (grad
enabled and an operand that requires grad).  The models route
differentiable calls through ``autograd.Function``s whose backward is a
kernel too: the attention at every (D, Dv) pair of the kernel,
multi-head latent attention's (192, 128) and (24, 16) included, under a
sliding window as without one, and the selective scan, whose forward then
writes its checkpoints; what the backward kernels do not take raises
before any launch.  These checks come before the device check, so meta
tensors show them on the CPU (the kernel wrappers replaced by recorders
of what they are handed); ``tests/test_torch_cuda.py`` shows them on the
card.  The CPU paths (the plain versions) stay differentiable, and the
backward's plain version equals autograd through the chunked attention.
"""
import pytest
import torch

from repro_torch.kernels import flash_attn, flash_attn_bwd, ssm_scan, \
    ssm_scan_bwd
from repro_torch.models import attention
from repro_torch.models import ssm as ssm_model


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
    with pytest.raises(RuntimeError, match="no gradient of its own"):
        ssm_scan.ssm_scan(*ops)
    with torch.inference_mode(), pytest.raises(ValueError, match="cuda"):
        ssm_scan.ssm_scan(*ops)                      # past the guard


@pytest.mark.parametrize("d,dv,window,match", [(64, 64, 16, "S <= T"),
                                               (64, 32, 0, "64, 32"),
                                               (8, 8, -1, "window")])
def test_model_attention_refuses_a_gradient_without_a_backward(d, dv, window,
                                                              match):
    """What the backward kernels do not take raises before any launch: a
    window over more query rows than keys (as the forward refuses), a pair
    outside ``flash_attn.PAIRS``, a negative window."""
    q, k, v = _meta(1, 32, 4, d), _meta(1, 16, 4, d), _meta(1, 16, 4, dv)
    with pytest.raises(ValueError, match=match):
        attention.flash_attention(q, k, v, window=window)


def _recorders(monkeypatch, seen):
    def fwd(q, k, v, *, causal, scale, window=0, out, lse):
        seen["fwd"] = (tuple(out.shape), tuple(lse.shape), scale, window)
        return out

    def bwd(q, k, v, out, dout, lse, *, causal, scale, window=0, dq, dk, dv):
        seen["bwd"] = [tuple(t.shape) for t in (out, dout, dq, dk, dv)]
        seen["bwd_window"] = window
        return dq, dk, dv

    monkeypatch.setattr(flash_attn, "flash_attention", fwd)
    monkeypatch.setattr(flash_attn_bwd, "flash_attention_bwd", bwd)


@pytest.mark.parametrize("window", [1, 16, 1024])
def test_model_attention_routes_a_window_through_the_kernels(monkeypatch,
                                                             window):
    """Under autograd a sliding window goes through ``_KernelAttention``
    as any pair does, and both the forward and the backward kernels get
    it."""
    seen = {}
    _recorders(monkeypatch, seen)
    q, k, v = (_meta(2, 16, h, 64) for h in (5, 1, 1))
    out = attention.flash_attention(q, k, v, window=window)
    assert type(out.grad_fn).__name__ == "_KernelAttentionBackward"
    assert seen["fwd"] == ((2, 5, 16, 64), (2, 5, 16), None, window)
    torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert seen["bwd_window"] == window
    assert seen["bwd"][2:] == [(2, 5, 16, 64), (2, 1, 16, 64),
                               (2, 1, 16, 64)]


def _ssm_params(di=32, n=16, r=4, grad=True):
    return {"x_proj": _meta(di, r + 2 * n, grad=grad),
            "dt_proj": _meta(r, di, grad=grad),
            "dt_bias": _meta(di, grad=grad), "a_log": _meta(di, n, grad=grad),
            "d_skip": _meta(di, grad=grad)}


def test_model_scan_routes_through_the_kernels(monkeypatch):
    """Under autograd the model's scan is ``_KernelScan``: the forward
    kernel gets a checkpoint buffer (a state a 16-step tile), and the
    backward kernel the operands, that buffer and the output's gradient
    (the final state's None: nothing reads it), and its seven gradients
    reach the operands."""
    seen = {}

    def fwd(dt, x, bmat, cmat, a, d_skip, h0, *, ckpt=None):
        seen["ckpt"] = None if ckpt is None else tuple(ckpt.shape)
        return torch.empty_like(x), torch.empty_like(h0)

    def bwd(dt, x, bmat, cmat, a, d_skip, h0, dy, dh=None, *, ckpt):
        seen["bwd"] = (tuple(dy.shape), dh, tuple(ckpt.shape))
        return tuple(torch.empty_like(t)
                     for t in (dt, x, bmat, cmat, a, d_skip, h0))

    monkeypatch.setattr(ssm_scan, "ssm_scan", fwd)
    monkeypatch.setattr(ssm_scan_bwd, "ssm_scan_bwd", bwd)
    p = _ssm_params()
    xc = _meta(2, 40, 32)
    y, state = ssm_model.ssm_scan(p, xc, _meta(2, 32, 16, grad=False))
    assert type(y.grad_fn).__name__ == "_KernelScanBackward"
    assert seen["ckpt"] == (2, 3, 32, 16)
    grads = torch.autograd.grad(y, [xc] + list(p.values()),
                                torch.empty_like(y))
    assert seen["bwd"] == ((2, 40, 32), None, (2, 3, 32, 16))
    assert [tuple(g.shape) for g in grads] == [(2, 40, 32)] + [
        tuple(t.shape) for t in p.values()]


def test_model_scan_without_a_gradient_writes_no_checkpoints(monkeypatch):
    """Serving (no operand requires grad, or grad disabled) launches the
    forward kernel alone, without the checkpoint buffer."""
    seen = []
    monkeypatch.setattr(ssm_scan, "ssm_scan", lambda *ops, ckpt=None: (
        seen.append(ckpt) or (torch.empty_like(ops[1]),
                              torch.empty_like(ops[6]))))
    ssm_model.ssm_scan(_ssm_params(grad=False), _meta(1, 8, 32, grad=False),
                       _meta(1, 32, 16, grad=False))
    with torch.no_grad():
        ssm_model.ssm_scan(_ssm_params(), _meta(1, 8, 32),
                           _meta(1, 32, 16, grad=False))
    assert seen == [None, None]


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

    _recorders(monkeypatch, seen)
    q, k, v = _meta(2, 16, 4, d), _meta(2, 16, 4, d), _meta(2, 16, 4, dv)
    out = attention.flash_attention(q, k, v, scale=0.3)
    assert type(out.grad_fn).__name__ == "_KernelAttentionBackward"
    assert tuple(out.shape) == (2, 16, 4, dv)
    assert seen["fwd"] == ((2, 4, 16, dv), (2, 4, 16), 0.3, 0)
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
        flash_attn_bwd.flash_attention_bwd(x, x[:, :, :4], x[:, :, :4], x, x,
                                           lse, window=4)
    with pytest.raises(ValueError, match="window"):
        flash_attn_bwd.flash_attention_bwd(x, x, x, x, x, lse, window=-1)
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
