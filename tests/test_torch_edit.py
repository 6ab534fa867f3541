"""The port's PPG editing (``ppgs_tpu_torch.edit``) and TextGrid copy
(``ppgs_tpu_torch.data.textgrid``) against the JAX package's, on the CPU,
on the same numpy PPGs and TextGrid files.

Tolerances: the edits at atol 1e-6 (elementwise fp32; they agree to the
bit here), with spans and argmax selections exact and the input tensor
left unchanged; grids at one fp32 ulp of the last frame index (the two
linspaces may round a point apart); ``sample`` on one grid at 1e-6;
``from_alignments`` at 1e-6; parsed TextGrids exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
import ppgs_tpu_torch
from ppgs_tpu.data import textgrid as jax_textgrid
from ppgs_tpu.edit import grid as jax_grid
from ppgs_tpu_torch.data import textgrid
from ppgs_tpu_torch.edit import grid
from ppgs_tpu_torch.phonemes import PHONEMES


def random_ppg(seed=0, frames=20):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((40, frames)).astype(np.float32)
    exp = np.exp(logits - logits.max(axis=0, keepdims=True))
    return exp / exp.sum(axis=0, keepdims=True)


def constant_run_ppg(sequence, run=5):
    """PPG whose argmax decode is the given phoneme sequence, run frames
    each."""
    frames = run * len(sequence)
    ppg = np.full((40, frames), 0.01, dtype=np.float32)
    for i, phone in enumerate(sequence):
        ppg[PHONEMES.index(phone), i * run:(i + 1) * run] = 0.9
    return ppg / ppg.sum(axis=0, keepdims=True)


def both(fn_name, ppg, *args, **kwargs):
    """(port, JAX) results of the edit ``fn_name`` on one numpy PPG; the
    port's input tensor must come back unchanged."""
    tensor = torch.from_numpy(ppg.copy())
    got = getattr(ppgs_tpu_torch.edit, fn_name)(tensor, *args, **kwargs)
    np.testing.assert_array_equal(tensor.numpy(), ppg)
    want = getattr(ppgs_tpu.edit, fn_name)(jnp.asarray(ppg), *args,
                                           **kwargs)
    return got, want


@pytest.mark.parametrize('fn_name,ppg,args', [
    ('reallocate', random_ppg(0), ('aa', 'iy')),
    ('reallocate', random_ppg(1), ('s', 'z', 0.01)),
    ('reallocate', random_ppg(8), ('t', 't')),
    ('swap', random_ppg(2), ('f', 'v')),
    ('shift', random_ppg(3), ('sh', 0.3)),
    ('shift', random_ppg(4), ('t', 0.2)),
    ('shift', random_ppg(9), ('m', -0.1)),
    ('regex', constant_run_ppg(['s', 'ih', 't']), (['s', 'ih'],
                                                   ['z', 'iy'])),
    ('regex', constant_run_ppg(['s', 'ih', 't', 's', 'ih']),
     (['s', 'ih'], ['z', 'iy'], True)),
    ('regex', random_ppg(10, frames=200), (['aa'], ['iy'])),
])
def test_edits_match_jax(fn_name, ppg, args):
    got, want = both(fn_name, ppg, *args)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('ppg,phonemes', [
    (constant_run_ppg(['s', 'ih', 't', 's', 'ih']), ['s', 'ih']),
    (constant_run_ppg(['aa', 'aa', 'b']), ['aa', 'b']),
    (random_ppg(11, frames=400), ['t']),
    (random_ppg(12, frames=400), ['zh', 'zh']),
])
def test_regex_find_matches_jax(ppg, phonemes):
    got, want = both('regex_find', ppg, phonemes)
    assert got == want


def test_numpy_ppg_goes_to_the_named_device(monkeypatch):
    ppg = random_ppg(5)
    out = ppgs_tpu_torch.edit.swap(ppg, 'f', 'v', device='cpu')
    assert isinstance(out, torch.Tensor) and out.device.type == 'cpu'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        ppgs_tpu_torch.edit.swap(ppg, 'f', 'v')


@pytest.mark.parametrize('frames,length', [(12, 12), (20, 40), (37, 23),
                                           (801, 1603)])
def test_grid_of_length_and_sample_match_jax(frames, length):
    ppg = random_ppg(6, frames)
    tensor = torch.from_numpy(ppg)
    got_grid = grid.of_length(tensor, length)
    want_grid = np.asarray(jax_grid.of_length(jnp.asarray(ppg), length))
    ulp = np.spacing(np.float32(frames - 1))
    np.testing.assert_allclose(got_grid.numpy(), want_grid, rtol=0, atol=ulp)
    got = grid.sample(tensor, torch.from_numpy(want_grid.copy()))
    want = np.asarray(jax_grid.sample(jnp.asarray(ppg), want_grid))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tensor.numpy(), ppg)


@pytest.mark.parametrize('ratio', [0.5, 1.3, 2.0])
def test_grid_constant_matches_jax(ratio):
    ppg = random_ppg(7, frames=20)
    got = grid.constant(torch.from_numpy(ppg), ratio)
    want = np.asarray(jax_grid.constant(jnp.asarray(ppg), ratio))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=np.spacing(np.float32(19)))


def test_grid_sample_between_frames_and_past_the_end():
    """Fractional, integral, negative and past-the-end indices, as JAX
    gathers them."""
    ppg = random_ppg(13, frames=10)
    g = np.array([0.5, 2.25, 3.0, 9.0, 9.5, -0.5], np.float32)
    got = grid.sample(torch.from_numpy(ppg), torch.from_numpy(g))
    want = np.asarray(jax_grid.sample(jnp.asarray(ppg), jnp.asarray(g)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def make_textgrid(module, path, phones, words=None):
    """phones: list of (label, start, end); words: list of (label, count)
    splitting the phones in order."""
    ph = [module.Phoneme(label, s, e) for label, s, e in phones]
    if words is None:
        words = [('w', len(ph))]
    grouped, i = [], 0
    for label, count in words:
        grouped.append(module.Word(label, ph[i:i + count]))
        i += count
    alignment = module.Alignment(grouped)
    alignment.save(path)
    return alignment


def parsed(alignment):
    return [(str(w), [(str(p), p.start, p.end) for p in w])
            for w in alignment.words()]


SOURCE = ([('hh', 0.0, 0.1), ('ah', 0.1, 0.3), ('l', 0.3, 0.45),
           ('ow', 0.45, 0.7), (ppgs_tpu.SILENCE, 0.7, 0.9)],
          [('hello', 4), ('', 1)])
TARGET = ([('hh', 0.0, 0.05), ('ah', 0.05, 0.35), ('l', 0.35, 0.4),
           ('ow', 0.4, 0.9), (ppgs_tpu.SILENCE, 0.9, 1.2)],
          [('hello', 4), ('', 1)])


def test_textgrid_round_trip_matches_jax(tmp_path):
    phones, words = SOURCE
    make_textgrid(textgrid, tmp_path / 'port.TextGrid', phones, words)
    make_textgrid(jax_textgrid, tmp_path / 'jax.TextGrid', phones, words)
    assert ((tmp_path / 'port.TextGrid').read_text()
            == (tmp_path / 'jax.TextGrid').read_text())
    got = textgrid.Alignment(tmp_path / 'port.TextGrid')
    want = jax_textgrid.Alignment(tmp_path / 'port.TextGrid')
    assert parsed(got) == parsed(want)
    assert got.duration() == want.duration() == pytest.approx(0.9)
    times = np.arange(90) * 0.01 + 0.005
    np.testing.assert_array_equal(
        got.framewise_phoneme_indices(ppgs_tpu_torch.PHONEME_TO_INDEX_MAPPING,
                                      0.01, times),
        want.framewise_phoneme_indices(ppgs_tpu.PHONEME_TO_INDEX_MAPPING,
                                       0.01, times))


def test_short_textgrid_parses_as_in_jax(tmp_path):
    path = tmp_path / 'short.TextGrid'
    path.write_text('\n'.join([
        'File type = "ooTextFile short"', '"TextGrid"', '', '0', '0.5',
        '<exists>', '2',
        '"IntervalTier"', '"words"', '0', '0.5', '1',
        '0', '0.5', '"at"',
        '"IntervalTier"', '"phones"', '0', '0.5', '2',
        '0', '0.2', '"ae"', '0.2', '0.5', '"t"']) + '\n')
    got, want = textgrid.Alignment(path), jax_textgrid.Alignment(path)
    assert parsed(got) == parsed(want) == [
        ('at', [('ae', 0.0, 0.2), ('t', 0.2, 0.5)])]


def test_from_alignments_matches_jax(tmp_path):
    for name, (phones, words) in (('source', SOURCE), ('target', TARGET)):
        make_textgrid(jax_textgrid, tmp_path / f'{name}.TextGrid', phones,
                      words)
    got = grid.from_alignments(
        textgrid.Alignment(tmp_path / 'source.TextGrid'),
        textgrid.Alignment(tmp_path / 'target.TextGrid'), device='cpu')
    want = np.asarray(jax_grid.from_alignments(
        jax_textgrid.Alignment(tmp_path / 'source.TextGrid'),
        jax_textgrid.Alignment(tmp_path / 'target.TextGrid')))
    assert got.dtype == torch.float32 and got.shape == want.shape == (120,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    ppg = random_ppg(14, frames=90)
    np.testing.assert_allclose(
        grid.sample(torch.from_numpy(ppg), got).numpy(),
        np.asarray(jax_grid.sample(jnp.asarray(ppg), want)), rtol=0,
        atol=1e-6)
