"""The port's synthetic data (``data/synthetic.py``) against the
reference's ``src/repro/data/synthetic.py``: the numpy tables bit for bit;
the draws, which come from a ``torch.Generator`` (``jax.random`` cannot be
reproduced), by their support and distribution.

Chi-square bound: the next-token counts of a row against the softmax of its
logits (successors that repeat in the row pooled) must stay under the
chi-square quantile at 1 - 1e-6 for their degrees of freedom, so a correct
sampler fails about once in a million runs per row; a sampler off by a few
percent of a successor's probability fails with these counts.
"""
import jax
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from repro.data import synthetic as jsyn
from repro_torch.data import synthetic as syn

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers


@pytest.mark.parametrize("vocab,n_modes", [(512, 64), (8192, 64), (100, 7)])
def test_markov_table_is_the_reference_bit_for_bit(vocab, n_modes):
    jn, jl = jsyn._markov_table(vocab, n_modes)
    n, l = syn._markov_table(vocab, n_modes)
    assert n.dtype == np.int32 and l.dtype == np.float32
    assert n.tobytes() == np.asarray(jn).tobytes() and l.tobytes() == np.asarray(jl).tobytes()


@pytest.mark.parametrize("n_classes,size", [(101, 32), (10, 16)])
def test_class_basis_is_the_reference_bit_for_bit(n_classes, size):
    want = np.asarray(jsyn._class_basis(n_classes, size))
    got = syn._class_basis(n_classes, size)
    assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_token_batches_follow_the_chain():
    cfg = syn.TokenPipelineConfig(vocab_size=512, seq_len=32, batch=4)
    nexts, _ = syn._markov_table(cfg.vocab_size, cfg.n_modes)
    stream = syn.token_batch_stream(cfg, seed=3)
    for _ in range(3):
        b = next(stream)
        tok, lab = b["tokens"].numpy(), b["labels"].numpy()
        assert tok.shape == lab.shape == (4, 32) and b["tokens"].dtype == torch.int64
        assert np.array_equal(tok[:, 1:], lab[:, :-1])
        assert all(lab[i, s] in nexts[tok[i, s]] for i in range(4) for s in range(32))
    again = next(syn.token_batch_stream(cfg, seed=3))
    first = next(syn.token_batch_stream(cfg, seed=3))
    assert torch.equal(again["tokens"], first["tokens"])   # seeded


def test_next_token_frequencies_match_the_softmax():
    """A 64-token chain with 8 successors a row, 40 batches of 16 x 64: the
    four most visited rows, each against the softmax of its logits."""
    cfg = syn.TokenPipelineConfig(vocab_size=64, seq_len=64, batch=16, n_modes=8)
    nexts, logits = syn._markov_table(cfg.vocab_size, cfg.n_modes)
    counts = np.zeros((cfg.vocab_size, cfg.vocab_size))
    stream = syn.token_batch_stream(cfg, seed=11)
    for _ in range(40):
        b = next(stream)
        np.add.at(counts, (b["tokens"].numpy().ravel(), b["labels"].numpy().ravel()), 1)
    for row in np.argsort(-counts.sum(1))[:4]:
        p = np.exp(logits[row] - logits[row].max())
        p /= p.sum()
        want = np.zeros(cfg.vocab_size)
        np.add.at(want, nexts[row], p)                  # repeated successors pooled
        support = want > 0
        n = counts[row].sum()
        assert counts[row][~support].sum() == 0
        stat = ((counts[row][support] - n * want[support]) ** 2 / (n * want[support])).sum()
        assert stat < chi2.ppf(1 - 1e-6, support.sum() - 1), (row, stat, n)


def test_image_batch_lies_in_the_references_ranges():
    """With no noise each image is its class pattern times one amplitude in
    [0.7, 1.3), rolled by a shift in [0, S) along the last axis; labels lie
    in [0, n_classes). The reference's draws, on the same terms, for scale."""
    n_classes, size, batch = 10, 16, 64
    basis = torch.from_numpy(syn._class_basis(n_classes, size)).double()
    g = torch.Generator().manual_seed(4)
    x, labels = syn.synthetic_image_batch(g, batch, size, n_classes=n_classes, noise=0.0)
    assert x.shape == (batch, 3, size, size) and x.dtype == torch.float32
    assert int(labels.min()) >= 0 and int(labels.max()) < n_classes
    amps = []
    for img, lab in zip(x.double(), labels):
        fits = []
        for s in range(size):
            ref = torch.roll(basis[lab], s, dims=-1)
            amp = float((img * ref).sum() / (ref * ref).sum())
            fits.append((float((img - amp * ref).abs().max()), amp))
        err, amp = min(fits)
        assert err < 1e-5 and 0.7 - 1e-6 <= amp < 1.3 + 1e-6
        amps.append(amp)
    assert max(amps) - min(amps) > 0.3          # the amplitude is drawn, not fixed
    xn, _ = syn.synthetic_image_batch(torch.Generator().manual_seed(4), batch, size,
                                      n_classes=n_classes, noise=0.3)
    assert abs(float((xn - x).std()) - 0.3) < 0.02
    jx, jl = jsyn.synthetic_image_batch(jax.random.PRNGKey(0), batch, size, n_classes=n_classes)
    assert 0 <= int(np.asarray(jl).min()) and int(np.asarray(jl).max()) < n_classes
    assert abs(float(np.asarray(jx).std()) - float(xn.std())) < 0.1
