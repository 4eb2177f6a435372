"""The paper's 5G application end to end on an NVIDIA GPU, twice:

1. *Simulated on TeraPool*: the cycle-level model reproducing Fig. 7
   (central vs partial barriers), on the port's simulator.
2. *Executed on the Hopper kernels*: one 5G NR slot (14 OFDM symbols)
   from 64 antennas of 4096 sub-carriers goes through the fused radix-4
   FFT kernel (OFDM demodulation) and the matmul kernel (32-beam
   beamforming), checked against numpy in complex128.  :func:`slot` is
   that device work alone, on inputs already on the device.

    PYTHONPATH=src python -m repro_torch.examples.fiveg_pipeline
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fiveg, prng
from repro_torch.kernels import ops, ref

# Deviation allowed from numpy's complex128 results.  The FFT bound is
# the reference's test tolerance: float32 rounding over log4(n) stages
# stays near 1e-4 at 4096 points.  The product's absolute bound scales
# with sqrt(K), as in the reference's matmul test.
FFT_RTOL, FFT_ATOL = 1e-3, 2e-3
MM_RTOL, MM_ATOL_PER_SQRT_K = 1e-4, 1e-4


def simulate(device="cuda") -> dict:
    """Fig. 7 at 4 FFTs per round for 16/32/64 antennas."""
    key = prng.PRNGKey(0, device=device)
    rows = {}
    for n_rx in (16, 32, 64):
        app = fiveg.FiveGConfig(n_rx=n_rx, ffts_per_round=4)
        rows[n_rx] = fiveg.compare_barriers(key, app, radix=32,
                                            device=device)
    return rows


def make_inputs(n_rx: int = 64, n_sc: int = 4096, n_beams: int = 32,
                n_symbols: int = 14, seed: int = 0) -> tuple:
    """One slot's inputs, made from ``seed`` with numpy: the time-domain
    streams ``re``, ``im`` (``n_rx * n_symbols`` rows of ``n_sc``
    samples, antenna-major) and the beamforming coefficients ``coef``
    (``n_beams`` x ``n_rx``), all float32."""
    rng = np.random.default_rng(seed)
    rows = n_rx * n_symbols
    re = rng.standard_normal((rows, n_sc), dtype=np.float32)
    im = rng.standard_normal((rows, n_sc), dtype=np.float32)
    coef = rng.standard_normal((n_beams, n_rx), dtype=np.float32)
    return re, im, coef


def slot(re_t: torch.Tensor, im_t: torch.Tensor,
         coef_t: torch.Tensor) -> dict:
    """OFDM demodulation and beamforming of one slot whose inputs already
    lie on the device: one ``ops.fft4`` over the rows, then two
    ``ops.matmul`` (real and imaginary planes).  Returns the
    digit-reversed spectrum ``(fr, fi)`` and the beams ``(beams_r,
    beams_i)`` of shape ``(n_beams, rows * n_sc / n_rx)``."""
    # OFDM demodulation: one radix-4 DIF FFT per antenna and symbol.
    fr, fi = ops.fft4(re_t, im_t)
    # Beamforming: (beams x antennas) @ (antennas x symbols*sub-carriers);
    # rows are antenna-major, so the reshape is a view.
    n_rx = coef_t.shape[1]
    cols = fr.numel() // n_rx
    beams_r = ops.matmul(coef_t, fr.reshape(n_rx, cols))
    beams_i = ops.matmul(coef_t, fi.reshape(n_rx, cols))
    return {"fr": fr, "fi": fi, "beams_r": beams_r, "beams_i": beams_i}


def execute(n_rx: int = 64, n_sc: int = 4096, n_beams: int = 32,
            n_symbols: int = 14, seed: int = 0, device="cuda") -> dict:
    """One slot end to end on ``device``: :func:`make_inputs`, the copy
    of the inputs to the device, then :func:`slot`.  Returns the numpy
    inputs (``re``, ``im``, ``coef``) and :func:`slot`'s outputs."""
    dev = resolve_device(device)
    re, im, coef = make_inputs(n_rx, n_sc, n_beams, n_symbols, seed)
    out = slot(*(torch.from_numpy(a).to(dev) for a in (re, im, coef)))
    return {"re": re, "im": im, "coef": coef, **out}


def check(out: dict) -> dict:
    """Hold :func:`execute`'s outputs against numpy in complex128 (the
    FFT in natural order after digit reversal) and return the largest
    absolute errors; raises if a tolerance is exceeded."""
    re, im, coef = out["re"], out["im"], out["coef"]
    n_sc = re.shape[1]
    idx = ref.digit_reverse_indices(n_sc, device="cpu").numpy()
    want = np.fft.fft(re.astype(np.float64) + 1j * im.astype(np.float64),
                      axis=-1)
    fr = out["fr"].cpu().numpy()
    fi = out["fi"].cpu().numpy()
    np.testing.assert_allclose(fr[:, idx], want.real, rtol=FFT_RTOL,
                               atol=FFT_ATOL)
    np.testing.assert_allclose(fi[:, idx], want.imag, rtol=FFT_RTOL,
                               atol=FFT_ATOL)
    n_rx = coef.shape[1]
    c64 = coef.astype(np.float64)
    atol = MM_ATOL_PER_SQRT_K * n_rx ** 0.5
    errs = {"fft": float(max(np.abs(fr[:, idx] - want.real).max(),
                             np.abs(fi[:, idx] - want.imag).max()))}
    for name, spec in (("beams_r", fr), ("beams_i", fi)):
        want_b = c64 @ spec.astype(np.float64).reshape(n_rx, -1)
        got = out[name].cpu().numpy()
        np.testing.assert_allclose(got, want_b, rtol=MM_RTOL, atol=atol)
        errs[name] = float(np.abs(got - want_b).max())
    return errs


def main(device="cuda") -> None:
    print("== TeraPool simulation (Fig. 7) ==")
    for n_rx, res in simulate(device).items():
        print(f" N_RX={n_rx:3d}: "
              f"central={float(res['central'].total_cycles):9.0f}cy"
              f"  partial32={float(res['partial'].total_cycles):9.0f}cy"
              f"  speedup={float(res['speedup_partial']):.2f}x"
              f"  sync={float(res['partial'].sync_fraction) * 100:.1f}%")
    print("\n== Hopper kernel pipeline (OFDM demod + beamforming) ==")
    out = execute(device=device)
    errs = check(out)
    rows, n_sc = out["re"].shape
    print(f" FFT: {rows} x {n_sc}-pt radix-4 OK (max err "
          f"{errs['fft']:.2e})")
    print(f" beamforming: {out['beams_r'].shape[0]} beams x "
          f"{out['beams_r'].shape[1]} columns OK (max err "
          f"{max(errs['beams_r'], errs['beams_i']):.2e})")
    power = (out["beams_r"] ** 2 + out["beams_i"] ** 2).mean(dim=1)
    print(" output power per beam:", np.round(power.cpu().numpy(), 1))


if __name__ == "__main__":
    main()
