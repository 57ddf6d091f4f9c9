"""SOFA (measured-HRIR) path of the crossfeed generator, end to end.

The SOFA chain was exercised only through the
synthetic fallback. This builds a HUTUBS-shaped SOFA fixture (HDF5 via
h5py: Data.IR [M, R, N], SourcePosition [M, 3], Data.SamplingRate) with
measured-like HRIRs whose per-position signatures let every stage be
checked: nearest-position selection at azimuth 330/30, receiver/ear
mapping, resample -> taper -> HF tilt -> trim -> DC normalization ->
export -> CrossfeedFilter -> CrossfeedProcessor magnitude envelopes.

Reference chain: scripts/filters/generate_hrtf.py:333-363.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from totton_tpu.engine.crossfeed import CrossfeedFilter, CrossfeedProcessor
from totton_tpu.filters.hrtf import (
    CROSSFEED_HF_CUTOFF_HZ,
    CROSSFEED_TARGET_DC_GAIN_DB,
    SofaHrirSource,
    generate_all,
    generate_crossfeed_set,
)

SOFA_RATE = 44100
N_IR = 256
# (azimuth, elevation): includes decoys so nearest-selection is load-bearing.
POSITIONS = [(0.0, 0.0), (30.0, 0.0), (90.0, 0.0), (330.0, 0.0),
             (270.0, 0.0), (30.0, 35.0)]


def _measured_like_hrir(delay_samples: float, gain: float,
                        marker: float) -> np.ndarray:
    """A plausible contralateral HRIR: band-limited fractional-delay onset,
    exponential decay, plus a tiny position 'marker' ripple that survives
    DC normalization (identifies WHICH measurement got picked)."""
    n = np.arange(N_IR)
    onset = np.sinc(n - delay_samples) * np.hanning(N_IR)
    t = np.maximum(n - delay_samples, 0.0) / SOFA_RATE
    h = gain * onset * np.exp(-t / 2e-3)
    h[int(delay_samples) + 4] += marker
    return h


@pytest.fixture(scope="module")
def sofa_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("sofa") / "M.sofa"
    m = len(POSITIONS)
    ir = np.zeros((m, 2, N_IR))
    for i, (az, el) in enumerate(POSITIONS):
        # Distinct per-position delay/gain/marker; receiver 0 = left ear,
        # receiver 1 = right ear (SOFA convention).
        ir[i, 0] = _measured_like_hrir(20 + 2 * i, 0.6, 0.05 * (i + 1))
        ir[i, 1] = _measured_like_hrir(24 + 2 * i, 0.5, 0.07 * (i + 1))
    with h5py.File(path, "w") as f:
        f.create_dataset("Data.IR", data=ir)
        f.create_dataset("SourcePosition",
                         data=np.array([(az, el, 1.47)
                                        for az, el in POSITIONS]))
        f.create_dataset("Data.SamplingRate", data=np.array([SOFA_RATE]))
    return path


class TestSofaSource:
    def test_picks_pm30_deg_measurements(self, sofa_file):
        pair = SofaHrirSource(sofa_file).load()
        assert pair.sample_rate == SOFA_RATE
        assert pair.meta["source"] == "sofa"
        # Left virtual speaker = azimuth 330 (index 3), right ear (rcv 1);
        # right speaker = azimuth 30 (index 1), left ear (rcv 0).
        assert pair.meta["position_left"][:2] == [330.0, 0.0]
        assert pair.meta["position_right"][:2] == [30.0, 0.0]
        # The position-unique markers identify the extracted rows:
        # lr = azimuth-330 row (i=3), receiver 1 -> marker 0.07*4 = 0.28;
        # rl = azimuth-30 row (i=1), receiver 0 -> marker 0.05*2 = 0.10.
        assert np.isclose(np.max(pair.lr), 0.28, atol=0.03)
        assert np.isclose(np.max(pair.rl), 0.10, atol=0.03)

    def test_elevation_tiebreak(self, sofa_file):
        """(30, 35) is a worse match than (30, 0)."""
        pair = SofaHrirSource(sofa_file).load()
        assert pair.meta["position_right"][1] == 0.0


class TestSofaChain:
    @pytest.fixture(scope="class")
    def built(self, sofa_file):
        pair = SofaHrirSource(sofa_file).load()
        channels, report = generate_crossfeed_set(pair, 705600)
        return pair, channels, report

    def test_dc_gain_normalized(self, built):
        _, channels, report = built
        for ch in (1, 2):  # LR, RL cross paths
            dc_db = 20 * np.log10(abs(channels[ch].sum()))
            assert abs(dc_db - CROSSFEED_TARGET_DC_GAIN_DB) < 0.01
        # Direct paths are unity impulses.
        assert channels[0][0] == 1.0 and np.all(channels[0][1:] == 0)

    def test_itd_preserved_through_resample(self, built):
        pair, channels, _ = built
        # Onset delay scales by the rate ratio (44100 -> 705600 = 16x).
        d_in = int(np.argmax(np.abs(pair.lr)))
        d_out = int(np.argmax(np.abs(channels[1])))
        assert abs(d_out - 16 * d_in) <= 32  # within 2 input samples

    def test_hf_tilt_envelope(self, built):
        """Magnitude above the shelf cutoff must sit well below the
        low-frequency envelope (the reference's HF tilt contract)."""
        _, channels, _ = built
        h = channels[1]
        H = np.abs(np.fft.rfft(h, 1 << 18))
        freqs = np.fft.rfftfreq(1 << 18, 1 / 705600)
        lo = H[(freqs > 100) & (freqs < 800)].mean()
        hi = H[(freqs > 4 * CROSSFEED_HF_CUTOFF_HZ)
               & (freqs < 20000)].mean()
        assert 20 * np.log10(hi / lo) < -10.0

    def test_export_load_process(self, sofa_file, tmp_path, rng):
        """Full chain into the runtime: SOFA -> export -> CrossfeedFilter
        -> CrossfeedProcessor, checking the processed audio's envelopes."""
        paths = generate_all(tmp_path, sizes=["M"], families=["44k"],
                             sofa_dir=sofa_file.parent)
        cf = CrossfeedFilter.load(paths[0])
        proc = CrossfeedProcessor(cf)
        bi = proc.block_input_frames
        # Left-only impulse train: the right output is pure crossfeed.
        x = np.zeros((2, 4 * bi), np.float32)
        x[0, :: bi // 4] = 1.0
        y = proc.process_block(x)
        assert y.shape == x.shape
        # Cross path energy ~ -10 dB DC gain: right output nonzero but
        # well below left.
        e_l = float(np.sum(y[0] ** 2))
        e_r = float(np.sum(y[1] ** 2))
        assert e_r > 0
        assert 10 * np.log10(e_r / e_l) < -10.0
        # And the generation report records the SOFA provenance.
        import json

        report = json.loads(open(paths[0]).read())
        assert report["source"] == "sofa"
        assert report["position_left"][:2] == [330.0, 0.0]
