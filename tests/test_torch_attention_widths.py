"""Attention at any head width: the kernels' wrappers zero-pad D to a
multiple of 8 (the scale stays 1/√D, the outputs are sliced back to D), and
``MultiHeadAttention`` sends a head wider than 256 to its eager path.

On the CPU the wrappers pad and run the kernels' plain versions, so the
padding and the route are held here against the unpadded eager attention
and the JAX package (whose Pallas kernels pad D the same way): forward to
``test_torch_flash_attention.py``'s bar, gradients to
``test_torch_flash_attention_bwd.py``'s, layers and a model to
``test_torch_nn.py``'s. The kernels themselves at D 100 are held against
their plain versions on a card by the ``cuda`` tests at the end. JAX is
imported inside the CPU tests only, so on a machine with a card and no JAX
this file collects and runs its ``cuda`` tests:
``python -m pytest --noconftest -m cuda tests/test_torch_attention_widths.py``.
"""
import numpy as np
import pytest
import torch

from test_torch_flash_attention_bwd import BF16_GRAD_TOL, F32_GRAD_TOL, _jax_grads
from transformertts_torch.nn import attention as t_attention
from transformertts_torch.ops import flash_attention as fa

torch.set_num_threads(1)

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
WIDTHS = [1, 4, 100, 252]     # padded to 8, 8, 104, 256


def _inputs(b, h, tq, tk, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for t in (tq, tk, tk))
    dout = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    bias = np.zeros((b, tk), np.float32)
    bias[0, tk * 3 // 4:] = fa.NEG_INF
    return q, k, v, bias, dout


def _t(*arrays, requires_grad=False):
    return [torch.from_numpy(a).requires_grad_(requires_grad) for a in arrays]


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _key_mask(b=2, t=11):
    mask = np.zeros((b, 1, 1, t), np.float32)
    mask[0, ..., 7:] = 1.0          # sample 0 padded after 7
    return mask


def _mha(model_dim, heads, dropout_rate=0.0):
    """The port's MultiHeadAttention and the JAX one holding the same
    weights, drawn by the JAX package."""
    from test_torch_nn import _port
    from transformertts_tpu.nn import attention as j_attention
    jm = j_attention.MultiHeadAttention(model_dim, heads, dropout_rate)
    tm = t_attention.MultiHeadAttention(model_dim, heads, dropout_rate)
    return jm, tm, _port(jm, tm)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('d', WIDTHS)
def test_padded_forward_equals_unpadded_eager_and_jax(d, causal):
    q, k, v, bias, _ = _inputs(2, 2, 19, 23 if not causal else 19, d)
    seen = []
    plain = fa.attention_plain

    def spy(*args, **kwargs):
        seen.append(args[0].shape[-1])
        return plain(*args, **kwargs)

    fa.attention_plain = spy
    try:
        out = fa.flash_attention(*_t(q, k, v, bias), causal=causal)
    finally:
        fa.attention_plain = plain
    assert seen == [-(-d // 8) * 8] and out.shape[-1] == d
    want = plain(*_t(q, k, v, bias), causal=causal)
    torch.testing.assert_close(out, want, **FWD_TOL)
    import jax.numpy as jnp
    from transformertts_tpu.ops import flash_attention as jfa
    j_out = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v, bias)), causal=causal,
                                interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **FWD_TOL)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('d', [4, 100])
def test_padded_gradients_equal_unpadded_autograd_and_jax(d, causal):
    q, k, v, bias, dout = _inputs(2, 2, 21, 21, d, seed=1)
    tq, tk, tv = _t(q, k, v, requires_grad=True)
    out = fa.flash_attention_trainable(tq, tk, tv, torch.from_numpy(bias), causal)
    assert out.shape[-1] == d
    mine = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    eq, ek, ev = _t(q, k, v, requires_grad=True)
    ref = torch.autograd.grad(fa.attention_plain(eq, ek, ev, torch.from_numpy(bias), causal),
                              (eq, ek, ev), torch.from_numpy(dout))
    for m, r, j in zip(mine, ref, _jax_grads(q, k, v, bias, dout, causal)):
        assert m.shape[-1] == d
        torch.testing.assert_close(m, r, **F32_GRAD_TOL)
        np.testing.assert_allclose(m.numpy(), j, **F32_GRAD_TOL)


def test_padded_wrappers_take_the_true_width_scale():
    """K2's logsumexp and K3/K4's outputs at D 100 are those of D 100, not
    of the padded 104: the scale is 1/√100."""
    q, k, v, bias, dout = _t(*_inputs(1, 2, 9, 9, 100, seed=2))
    out, lse = fa.flash_attention_fwd_lse(q, k, v, bias)
    ref_out, ref_lse = fa.attention_fwd_lse_plain(q, k, v, bias)
    torch.testing.assert_close(lse, ref_lse, **FWD_TOL)
    torch.testing.assert_close(out, ref_out, **FWD_TOL)
    ref = fa.attention_bwd_plain(q, k, v, bias, ref_out, ref_lse, dout)
    dq = fa.flash_attention_bwd_dq(q, k, v, bias, out, lse, dout)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout)
    for m, r in zip((dq, dk, dv), ref):
        assert m.shape == r.shape
        torch.testing.assert_close(m, r, **F32_GRAD_TOL)


def test_wrappers_refuse_heads_wider_than_256():
    q, k, v, bias, dout = _t(*_inputs(1, 1, 4, 4, 264))
    with pytest.raises(ValueError, match='head width'):
        fa.flash_attention(q, k, v, bias)
    with pytest.raises(ValueError, match='head width'):
        fa.flash_attention_fwd_lse(q, k, v, bias)
    with pytest.raises(ValueError, match='head width'):
        fa.flash_attention_bwd_dq(q, k, v, bias, q, torch.zeros(1, 1, 4, 2), dout)


class _Routes:
    """Records which of ``_attend``'s two routes each call took."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ('flash_attention', 'flash_attention_trainable',
                     'scaled_dot_product_attention'):
            fn = getattr(t_attention, name)
            monkeypatch.setattr(t_attention, name, self._spy(name, fn))

    def _spy(self, name, fn):
        def spy(q, *args, **kwargs):
            self.calls.append((name, q.shape[-1]))
            return fn(q, *args, **kwargs)
        return spy


@pytest.mark.parametrize('model_dim, heads, route', [
    (200, 2, 'kernel'), (64, 16, 'kernel'), (256, 1, 'kernel'), (384, 1, 'eager'),
    (600, 2, 'eager')])
def test_attend_route_depends_on_the_head_width(monkeypatch, model_dim, heads, route):
    _, tm, _ = _mha(model_dim, heads, dropout_rate=0.1)
    routes = _Routes(monkeypatch)
    x = torch.from_numpy(_rand(2, 11, model_dim)).requires_grad_(True)
    mask = torch.from_numpy(_key_mask())
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        tm(x, x, x, mask, need_weights=False)                        # serving: K1
    out, weights = tm(x, x, x, mask, need_weights=False, training=True, generator=gen,
                      causal=True)                                   # training: K2-K4
    out.sum().backward()
    assert weights is None and torch.isfinite(x.grad).all()
    depth = model_dim // heads
    want = ([('flash_attention', depth), ('flash_attention_trainable', depth)]
            if route == 'kernel' else [('scaled_dot_product_attention', depth)] * 2)
    assert routes.calls == want


@pytest.mark.parametrize('model_dim, heads', [(200, 2), (384, 1)], ids=['D100', 'D384'])
@pytest.mark.parametrize('need_weights', [False, True])
def test_multi_head_attention_at_odd_and_wide_heads_matches_jax(model_dim, heads,
                                                                need_weights):
    import jax
    import jax.numpy as jnp
    from test_torch_nn import _close
    jm, tm, params = _mha(model_dim, heads)
    x, mask = _rand(2, 11, model_dim, seed=3), _key_mask()
    j_out, _ = jm.apply(params, *(jnp.asarray(x),) * 3, jnp.asarray(mask))
    tx = torch.from_numpy(x).requires_grad_(True)
    t_out, weights = tm(tx, tx, tx, torch.from_numpy(mask), need_weights=need_weights)
    assert (weights is None) != need_weights
    _close(t_out, j_out)

    def j_loss(p, xx):
        return jnp.sum(jm.apply(p, xx, xx, xx, jnp.asarray(mask))[0] ** 2)

    j_gx = jax.grad(j_loss, argnums=1)(params, jnp.asarray(x))
    (t_out ** 2).sum().backward()
    _close(tx.grad, j_gx, atol=1e-4)


@pytest.mark.parametrize('model_dim, heads', [(200, 2), (384, 1)], ids=['D100', 'D384'])
def test_forward_transformer_at_odd_and_wide_heads_matches_jax(tmp_path, model_dim, heads):
    """A whole model whose heads are 100 or 384 wide loads and runs through
    the port's attention on the CPU, as in JAX."""
    from test_torch_nn import jax_and_port_models
    jm, tm = jax_and_port_models(
        tmp_path, encoder_model_dimension=model_dim, decoder_model_dimension=model_dim,
        encoder_num_heads=[heads], decoder_num_heads=[heads],
        encoder_attention_conv_filters=[64, model_dim],
        decoder_attention_conv_filters=[64, model_dim])
    assert tm.config['encoder_num_heads'] == [heads]
    j_out = jm.predict('hello there')
    t_out = tm.predict('hello there')
    assert t_out['mel'].shape == j_out['mel'].shape
    assert np.abs(t_out['mel'] - np.asarray(j_out['mel'])).mean() < 1e-4
    np.testing.assert_allclose(t_out['duration'], np.asarray(j_out['duration']), atol=1e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# on the card: K1-K4 at padded widths against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('the CUDA kernels run only on a card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('causal', [False, True])
def test_kernels_at_head_width_100_match_plain_on_card(cuda, causal, dtype):
    dt = getattr(torch, dtype)
    q, k, v, bias, dout = (x.to(cuda) for x in _t(*_inputs(2, 2, 150, 150, 100, seed=4)))
    q, k, v, dout = (x.to(dt) for x in (q, k, v, dout))
    ops = (fa.flash_attention, fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
           fa.flash_attention_bwd_dkv)
    counts = [f.launches for f in ops]
    out1 = fa.flash_attention(q, k, v, bias, causal)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, bias, causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, causal)
    torch.cuda.synchronize()
    assert [f.launches for f in ops] == [c + 1 for c in counts]
    fwd_tol = FWD_TOL if dt == torch.float32 else dict(atol=3e-2, rtol=3e-2)
    ref_out, ref_lse = fa.attention_fwd_lse_plain(q, k, v, bias, causal)
    for o in (out1, out):
        assert o.shape[-1] == 100
        torch.testing.assert_close(o.float(), ref_out.float(), **fwd_tol)
    torch.testing.assert_close(lse, ref_lse, **FWD_TOL)
    grad_tol = F32_GRAD_TOL if dt == torch.float32 else BF16_GRAD_TOL
    for m, r in zip((dq, dk, dv), fa.attention_bwd_plain(q, k, v, bias, out, lse, dout,
                                                         causal)):
        assert m.shape[-1] == 100 and m.dtype == dt
        torch.testing.assert_close(m.float(), r.float(), **grad_tol)


@pytest.mark.cuda
def test_wide_head_takes_the_eager_path_on_card(cuda, monkeypatch):
    routes = _Routes(monkeypatch)
    tm = t_attention.MultiHeadAttention(384, 1)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    tm = tm.to(cuda)
    x = torch.from_numpy(_rand(2, 11, 384)).to(cuda)
    with torch.no_grad():
        out, _ = tm(x, x, x, torch.from_numpy(_key_mask()).to(cuda), need_weights=False)
    assert routes.calls == [('scaled_dot_product_attention', 384)]
    assert torch.isfinite(out).all()
