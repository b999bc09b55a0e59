import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fea_tpu.models import FDNUNet, UNet, create_models

REFERENCE = "/root/reference"


def _init_trio(S=32, B=2):
    enc, dec, aux = create_models(
        input_dim=64,
        image_height=S,
        image_width=S,
        num_channels=2,
        num_auxiliary_condition_channels=3,
        num_stages=4,
    )
    rng = jax.random.PRNGKey(0)
    materials = jnp.zeros((B, S, S, 2), jnp.float32)
    conditions = jnp.zeros((B, S, S, 3), jnp.float32)
    ev = enc.init(rng, materials, conditions)
    x, hidden, residual = enc.apply(ev, materials, conditions)
    dv = dec.init(rng, x, list(hidden), residual)
    av = aux.init(rng, x)
    return (enc, dec, aux), (ev, dv, av), (materials, conditions, x, hidden, residual)


def test_fdnunet_trio_shapes():
    S, B = 32, 2
    (enc, dec, aux), (ev, dv, av), (materials, conditions, x, hidden, residual) = (
        _init_trio(S, B)
    )
    # middle: S/8 spatial, 512 channels
    assert x.shape == (B, S // 8, S // 8, 512)
    assert len(hidden) == 8
    assert residual.shape == (B, S, S, 64)

    out = dec.apply(dv, x, list(hidden), residual)
    assert out.shape == (B, S, S, 2)

    sign, log = aux.apply(av, x)
    assert sign.shape == (B, 4) and log.shape == (B, 4)
    assert (np.asarray(sign) >= 0).all() and (np.asarray(sign) <= 1).all()


def _count(tree):
    return sum(x.size for x in jax.tree.leaves(tree))


@pytest.mark.skipif(not os.path.isdir(REFERENCE), reason="reference not mounted")
def test_param_count_parity_with_reference():
    """Topology check: our modules have exactly the reference torch
    modules' parameter counts (same dims/connectivity, NHWC vs NCHW)."""
    sys.path.insert(0, REFERENCE)
    try:
        from model.fdnunetwithaux import create_models as torch_create
    finally:
        sys.path.pop(0)

    t_enc, t_dec, t_aux = torch_create(
        input_dim=64,
        image_height=32,
        image_width=32,
        num_channels=2,
        num_auxiliary_condition_channels=3,
        num_stages=4,
    )
    t_counts = [
        sum(p.numel() for p in m.parameters()) for m in (t_enc, t_dec, t_aux)
    ]

    _, (ev, dv, av), _ = _init_trio(S=32)
    j_counts = [_count(v["params"]) for v in (ev, dv, av)]
    assert j_counts == t_counts, f"jax {j_counts} vs torch {t_counts}"


def test_monolithic_fdnunet_forward():
    S, B = 32, 1
    model = FDNUNet(
        input_dim=32,
        num_stages=3,
        num_channels=2,
        num_auxiliary_condition_channels=3,
        attention_head_dim=8,
        num_attention_heads=2,
    )
    rng = jax.random.PRNGKey(0)
    x = jnp.ones((B, S, S, 2))
    cond = jnp.zeros((B, S, S, 3))
    variables = model.init(rng, x, cond)
    out = model.apply(variables, x, cond)
    assert out.shape == (B, S, S, 2)
    # amax normalization: per-channel max is 1
    np.testing.assert_allclose(
        np.asarray(out).max(axis=(1, 2)), 1.0, rtol=1e-5
    )


def test_plain_unet_forward():
    S, B = 32, 1
    model = UNet(
        input_dim=32,
        num_stages=3,
        num_channels=2,
        num_condition_channels=4,
        attention_head_dim=8,
        num_attention_heads=2,
    )
    rng = jax.random.PRNGKey(0)
    x = jnp.ones((B, S, S, 2))
    cond = jnp.zeros((B, S, S, 4))
    variables = model.init(rng, x, cond)
    out = model.apply(variables, x, cond)
    assert out.shape == (B, S, S, 2)


def test_fdnunet_time_embedding_mode():
    S = 16
    model = FDNUNet(
        input_dim=16,
        num_stages=2,
        num_channels=2,
        num_auxiliary_condition_channels=3,
        attention_head_dim=8,
        num_attention_heads=2,
        use_time_embedding=True,
    )
    rng = jax.random.PRNGKey(0)
    x = jnp.ones((1, S, S, 2))
    cond = jnp.zeros((1, S, S, 3))
    t = jnp.array([0.5])
    variables = model.init(rng, x, cond, time=t)
    out = model.apply(variables, x, cond, time=t)
    assert out.shape == (1, S, S, 2)


def test_diffusion_mode_loss_and_sampling():
    from fea_tpu.models.diffusion import make_diffusion_model

    S = 16
    diffusion = make_diffusion_model(
        image_size=S,
        input_dim=16,
        num_stages=2,
        timesteps=8,
        attention_head_dim=8,
        num_attention_heads=2,
    )
    rng = jax.random.PRNGKey(0)
    variables = diffusion.init(rng, S, batch=2)
    params = variables["params"]

    x0 = jax.random.normal(jax.random.PRNGKey(1), (2, S, S, 2))
    cond = jax.random.normal(jax.random.PRNGKey(2), (2, S, S, 5))
    loss = diffusion.loss(params, jax.random.PRNGKey(3), x0, cond)
    assert np.isfinite(float(loss))

    grads = jax.grad(
        lambda p: diffusion.loss(p, jax.random.PRNGKey(4), x0, cond)
    )(params)
    gnorm = sum(float(jnp.sum(g**2)) for g in jax.tree.leaves(grads))
    assert np.isfinite(gnorm) and gnorm > 0

    samples = diffusion.sample(params, jax.random.PRNGKey(5), cond, 4)
    assert samples.shape == (2, S, S, 2)
    assert np.isfinite(np.asarray(samples)).all()


def test_fdnunet_flash_attention_variant():
    """The attention variant's full-attention block (RMSNorm -> 1x1 qkv ->
    memory KV -> softmax attention -> 1x1 out) against a float64 NumPy
    implementation with the same parameters."""
    from fea_tpu.models.attention import full_attention
    from fea_tpu.models.layers import Scope

    S = 32
    model = FDNUNet(
        input_dim=16,
        num_stages=2,
        num_channels=2,
        num_auxiliary_condition_channels=3,
        attention_head_dim=8,
        num_attention_heads=2,
    )
    x = jax.random.normal(jax.random.PRNGKey(1), (1, S, S, 2), jnp.float32)
    cond = jax.random.normal(jax.random.PRNGKey(2), (1, S, S, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), x, cond)
    out = model.apply(variables, x, cond)
    assert out.shape == (1, S, S, 2) and np.isfinite(np.asarray(out)).all()

    p = variables["params"]["middle_attention"]
    heads, hd = 2, 8
    h = jax.random.normal(jax.random.PRNGKey(3), (2, 8, 8, 32), jnp.float32)
    with jax.default_matmul_precision("highest"):
        got = full_attention(
            Scope({"middle_attention": p}), h, heads, hd, name="middle_attention"
        )

    f = lambda a: np.asarray(a, np.float64)
    hn = f(h)
    b, H, W, c = hn.shape
    xn = hn * np.sqrt(c) / np.maximum(
        np.linalg.norm(hn, axis=-1, keepdims=True), 1e-12
    ) * f(p["RMSNorm_0"]["g"])
    qkv = xn @ f(p["Conv_0"]["kernel"])[0, 0]
    q, k, v = np.split(qkv.reshape(b, H * W, 3 * heads * hd), 3, axis=-1)
    q, k, v = (t.reshape(b, H * W, heads, hd).transpose(0, 2, 1, 3) for t in (q, k, v))
    mem = f(p["memory_kv"])
    k = np.concatenate([np.broadcast_to(mem[0], (b,) + mem[0].shape), k], axis=2)
    v = np.concatenate([np.broadcast_to(mem[1], (b,) + mem[1].shape), v], axis=2)
    s = q @ k.transpose(0, 1, 3, 2) / np.sqrt(hd)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    o = (w @ v).transpose(0, 2, 1, 3).reshape(b, H, W, heads * hd)
    want = o @ f(p["Conv_1"]["kernel"])[0, 0] + f(p["Conv_1"]["bias"])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)


def test_flagship_parameter_counts():
    """The flagship trio (input_dim 64, 4 stages, 256 px) keeps the
    reference's parameter counts."""
    S = 256
    enc, dec, aux = create_models(
        input_dim=64, image_height=S, image_width=S, num_channels=2,
        num_auxiliary_condition_channels=3, num_stages=4,
    )
    key = jax.random.PRNGKey(0)
    m = jax.ShapeDtypeStruct((1, S, S, 2), jnp.float32)
    c = jax.ShapeDtypeStruct((1, S, S, 3), jnp.float32)
    ev = jax.eval_shape(enc.init, key, m, c)
    x, hidden, residual = jax.eval_shape(enc.apply, ev, m, c)
    dv = jax.eval_shape(dec.init, key, x, list(hidden), residual)
    av = jax.eval_shape(aux.init, key, x)
    counts = [
        sum(int(np.prod(l.shape)) for l in jax.tree.leaves(v))
        for v in (ev, dv, av)
    ]
    assert counts == [41_093_440, 18_471_106, 134_417_416]


def _golden_params(paths_shapes, seed=0):
    """Deterministic parameters for the small-trio golden: the same
    procedure, over the same sorted key paths, produced the golden's
    outputs from the flax implementation this package replaced."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in sorted(paths_shapes):
        name = path.rsplit("/", 1)[-1]
        n = rng.standard_normal(shape).astype(np.float32)
        if name in ("scale", "g"):
            v = 1.0 + 0.1 * n
        elif name == "bias":
            v = 0.1 * n
        elif name == "memory_kv":
            v = n
        else:
            v = n / np.sqrt(np.prod(shape[:-1]))
        out[path] = v.astype(np.float32)
    return out


def test_small_trio_matches_golden():
    """The trio at input_dim 8, 32 px reproduces the outputs recorded in
    tests/goldens/fdnunet_small_golden.npz (float32, highest precision)."""
    from fea_tpu.train.checkpoint import flatten, unflatten

    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "fdnunet_small_golden.npz"))
    S = 32
    enc, dec, aux = create_models(
        input_dim=8, image_height=S, image_width=S, num_channels=2,
        num_auxiliary_condition_channels=3, num_stages=4,
    )
    m = jnp.asarray(g["materials"])
    c = jnp.asarray(g["conditions"])
    key = jax.random.PRNGKey(0)
    with jax.default_matmul_precision("highest"):
        ev = enc.init(key, m, c)
        x, hidden, residual = enc.apply(ev, m, c)
        tree = {
            "encoder": ev["params"],
            "decoder": dec.init(key, x, list(hidden), residual)["params"],
            "auxiliary": aux.init(key, x)["params"],
        }
        flat = flatten(tree)
        assert sorted(flat) == list(g["param_paths"])
        params = unflatten(
            _golden_params([(k, v.shape) for k, v in flat.items()])
        )
        x, hidden, residual = enc.apply({"params": params["encoder"]}, m, c)
        image = dec.apply({"params": params["decoder"]}, x, list(hidden), residual)
        sign, log = aux.apply({"params": params["auxiliary"]}, x)
    for got, name in ((x, "middle"), (image, "image"), (sign, "sign"), (log, "log")):
        assert got.dtype == jnp.float32
        np.testing.assert_allclose(
            np.asarray(got), g[name], rtol=1e-5, atol=1e-6, err_msg=name
        )


def test_amax_normalize_zero_divisor_guard():
    """amax_normalize must stay finite when the spatial max is 0 (the
    unguarded reference quirk yields 0/0 = NaN; observed poisoning the
    2026-08-18 bf16 production run) and be exact elsewhere."""
    import jax.numpy as jnp

    from fea_tpu.models.blocks import amax_normalize

    # healthy case: identical to plain division
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 8, 8, 3)))
    np.testing.assert_allclose(
        np.asarray(amax_normalize(x)),
        np.asarray(x / jnp.max(x, axis=(1, 2), keepdims=True)),
    )
    # pathological case: all-nonpositive with zeros present
    z = jnp.asarray(-np.random.default_rng(1).random((1, 4, 4, 2)))
    z = z.at[0, 0, 0, :].set(0.0)
    out = np.asarray(amax_normalize(z))
    assert np.isfinite(out).all()
