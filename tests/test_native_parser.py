"""Native C++ HITRAN parser vs the NumPy parser (C1 native tier)."""

import time

import numpy as np
import pytest

from spectrobot_tpu.data import hitran_native
from spectrobot_tpu.data.hitran import parse_par_text
from spectrobot_tpu.data.synth import co2_15um_band, random_lines
from spectrobot_tpu.data.hitran import format_par_record

needs_native = pytest.mark.skipif(not hitran_native.available(),
                                  reason="native library not built")


def _sample_text(n=500, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        recs.append(format_par_record(
            mol_id=int(rng.integers(1, 7)), iso_id=int(rng.integers(1, 4)),
            nu0=float(rng.uniform(1, 4000)), sw=float(10 ** rng.uniform(-25, -18)),
            a=float(rng.uniform(0.1, 10)), gamma_air=float(rng.uniform(0.01, 0.2)),
            gamma_self=float(rng.uniform(0.01, 0.3)),
            elower=float(rng.uniform(0, 5000)), n_air=float(rng.uniform(0.3, 0.9)),
            delta_air=float(rng.uniform(-0.01, 0.01)),
            gq_u=f"V{i % 7}", gq_l="GND", lq_u=f"J{i % 40}", lq_l=f"J{i % 40 + 1}",
            gp=float(2 * (i % 40) + 1), gpp=float(2 * (i % 40) + 3)))
    return "\n".join(recs)


@needs_native
def test_native_matches_numpy_parser():
    text = _sample_text(500)
    a = parse_par_text(text, use_native="never")
    b = parse_par_text(text, use_native="always")
    assert len(a) == len(b) == 500
    for f in ("nu0", "sw", "gamma_air", "gamma_self", "elower", "n_air",
              "delta_air", "gp", "gpp", "mass_amu"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=1e-12,
                                   err_msg=f)
    np.testing.assert_array_equal(b.mol_id, a.mol_id)
    np.testing.assert_array_equal(b.iso_id, a.iso_id)
    assert list(b.quanta_global_u) == list(a.quanta_global_u)
    assert list(b.quanta_local_l) == list(a.quanta_local_l)


@needs_native
def test_native_handles_edge_inputs():
    # Blank lines are skipped; a trailing newline-less record parses.
    text = "\n" + _sample_text(3).rstrip("\n")
    ll = parse_par_text(text, use_native="always")
    assert len(ll) == 3
    # Truncated/junk records are REJECTED loudly (round-4 contract: both
    # engines refuse to silently drop records — round-3 review item 5).
    import pytest
    with pytest.raises(ValueError, match="malformed .par record"):
        parse_par_text("junk\n" + _sample_text(3), use_native="always")
    # Empty input
    assert len(parse_par_text("", use_native="never")) == 0


@needs_native
def test_native_is_faster():
    # Best-of-3 per parser: a single-shot comparison flakes under full-suite
    # load on this 2-core host (observed round 3); the minimum is robust to
    # scheduler noise while still asserting the native path's advantage
    # (it wins by ~10-50x on millions of records).
    text = _sample_text(5000)
    def best(mode):
        ts = []
        for _ in range(3):
            t0 = time.time()
            parse_par_text(text, use_native=mode)
            ts.append(time.time() - t0)
        return min(ts)
    t_np = best("never")
    t_cc = best("always")
    assert t_cc < t_np, (t_cc, t_np)
