"""The port's Config and alphabet tables against the JAX package's."""
import numpy as np
import pytest

from amp_sparc_spatialmodulation_tpu import alphabets as jalph
from amp_sparc_spatialmodulation_tpu import config as jconfig
from amp_sparc_spatialmodulation_tpu_torch import alphabets as talph
from amp_sparc_spatialmodulation_tpu_torch import config as tconfig

DERIVED = ("sparsity", "Lout", "ISI", "N", "n", "Ns", "N0", "K",
           "symbol_bits", "modulated", "Ps", "P0", "M", "L", "index_bits",
           "info_bits", "inner_code_rate", "code_rate", "Mc", "Mr", "Lc",
           "Lr", "N_Layers", "kappa", "min_amp_snr", "min_snr", "min_snr_dB",
           "shannon_limit_dB", "E", "name", "cdtype", "is_complex")

CASES = [
    dict(Nt=128, Na=8, Nr=24, Lin=20, Lh=3, B=1, mode="segmented",
         iterations=100, alphabet="OOK", profile="uniform", trunc="tail"),
    dict(Nt=128, Na=4, Nr=32, Lin=20, Lh=3, mode="random",
         alphabet="16PSK", profile="exponential", trunc="trunc"),
    dict(Nt=128, Na=16, Nr=16, Lin=40, Lh=9, mode="sparc", alphabet="QPSK",
         profile="uniform", trunc="tail"),
    dict(Nt=16, Na=2, Nr=4, Lin=4, Lh=2, alphabet="QPSK", is_complex=False),
    dict(Nt=24, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented", alphabet="OOK",
         trunc="cyclic"),
    dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented", alphabet="16QAM",
         fix_16qam=True),
    dict(Nt=16, Na=4, Nr=8, Lin=8, Lh=3, mode="segmented", alphabet="4ASK",
         is_complex=False),
]
PRESETS = ("flagship_bamp_ook", "flagship_bamp_qpsk", "massive_mimo",
           "flagship_scamp")


def _assert_same_config(j, t):
    for f in DERIVED:
        assert getattr(t, f) == getattr(j, f), f
    np.testing.assert_array_equal(t.symbols, j.symbols)
    assert t.symbols.dtype == j.symbols.dtype
    np.testing.assert_array_equal(t.gray, j.gray)
    np.testing.assert_array_equal(t.pdp, j.pdp)
    for snr in (0.5, 3.0, 100.0):
        assert t.sigma2(snr) == j.sigma2(snr)


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: kw["alphabet"])
def test_derived_fields_match(kw):
    _assert_same_config(jconfig.Config(**kw), tconfig.Config(**kw))


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_match(preset):
    j, t = getattr(jconfig, preset)(), getattr(tconfig, preset)()
    assert tconfig.Config.__dataclass_fields__.keys() \
        == jconfig.Config.__dataclass_fields__.keys()
    for f in jconfig.Config.__dataclass_fields__:
        assert getattr(t, f) == getattr(j, f), f
    _assert_same_config(j, t)


def test_validation_errors_match():
    bad = [dict(Nt=16, Na=3, Nr=4, Lin=4, Lh=2, mode="segmented"),
           dict(Nt=16, Na=2, Nr=4, Lin=4, Lh=0),
           dict(Nt=16, Na=2, Nr=4, Lin=4, Lh=2, alphabet="QAM64"),
           dict(Nt=16, Na=2, Nr=4, Lin=4, Lh=2, trunc="wrap")]
    for kw in bad:
        with pytest.raises(ValueError):
            jconfig.Config(**kw)
        with pytest.raises(ValueError):
            tconfig.Config(**kw)


def test_replace_and_hash():
    a, b = tconfig.flagship_bamp_ook(), tconfig.flagship_bamp_ook()
    assert hash(a) == hash(b) and a == b
    assert a != a.replace(Nr=25)


@pytest.mark.parametrize("fix", [False, True])
@pytest.mark.parametrize("name", jalph.ALPHABET_NAMES)
def test_alphabet_tables_match(name, fix):
    j, t = jalph.get_alphabet(name, fix), talph.get_alphabet(name, fix)
    np.testing.assert_array_equal(t.symbol_array(), j.symbol_array())
    np.testing.assert_array_equal(t.gray_array(), j.gray_array())
    assert (t.K, t.symbol_bits, t.modulated, t.forces_complex) \
        == (j.K, j.symbol_bits, j.modulated, j.forces_complex)


def test_16qam_duplicate_and_fix():
    raw = talph.get_alphabet("16QAM").symbol_array()
    fixed = talph.get_alphabet("16QAM", fix_16qam=True).symbol_array()
    assert len(set(np.round(raw, 6).tolist())) == 15
    assert len(set(np.round(fixed, 6).tolist())) == 16
