"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aad_tpu.parallel.sharded import (
    decode_blocks_sharded,
    encode_streams_sharded,
    make_mesh,
)
from aad_tpu.ops.decode import decode_blocks
from aad_tpu.ops.encode import encode_stream_blocks


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


class TestShardedDecode:
    def test_matches_unsharded(self, mesh):
        rng = np.random.default_rng(0)
        L, T = 100, 236  # deliberately not a multiple of mesh size
        codes = jnp.asarray(rng.integers(0, 16, (L, T)).astype(np.int32))
        si = jnp.asarray(rng.integers(0, 4081, L).astype(np.int32))
        w = jnp.asarray(rng.integers(-20000, 20000, (L, 4)).astype(np.int32))
        h = jnp.asarray(rng.integers(-32768, 32768, (L, 4)).astype(np.int32))

        sharded = decode_blocks_sharded(
            codes, si, w, h, bits_per_sample=4, mesh=mesh, engine="scan"
        )
        local = decode_blocks(codes, si, w, h, bits_per_sample=4, engine="scan")
        np.testing.assert_array_equal(np.asarray(sharded), np.asarray(local))

    def test_output_sharding(self, mesh):
        rng = np.random.default_rng(1)
        L, T = 64, 60
        codes = jnp.asarray(rng.integers(0, 16, (L, T)).astype(np.int32))
        si = jnp.zeros(L, jnp.int32)
        w = jnp.zeros((L, 4), jnp.int32)
        h = jnp.zeros((L, 4), jnp.int32)
        out = decode_blocks_sharded(
            codes, si, w, h, bits_per_sample=4, mesh=mesh, engine="scan"
        )
        assert len(out.sharding.device_set) == 8


class TestShardedEncode:
    def test_matches_unsharded(self, mesh):
        rng = np.random.default_rng(2)
        S, B, C, nspb = 5, 3, 2, 60
        blocks = jnp.asarray(rng.integers(-20000, 20000, (S, B, C, nspb)).astype(np.int32))
        valid = jnp.full((S, B), nspb, dtype=jnp.int32)

        headers, codes, stat = encode_streams_sharded(
            blocks, valid, bits_per_sample=4, num_trials=1, mesh=mesh
        )
        assert stat is None  # quality stat is opt-in (stat=True)
        for s in range(S):
            h_ref, c_ref = encode_stream_blocks(blocks[s], valid[s], 4, 1)
            np.testing.assert_array_equal(np.asarray(codes[s]), np.asarray(c_ref))
            np.testing.assert_array_equal(
                np.asarray(headers.step_index[s]), np.asarray(h_ref.step_index)
            )
            np.testing.assert_array_equal(
                np.asarray(headers.weight[s]), np.asarray(h_ref.weight)
            )


MESH_SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]


@pytest.mark.parametrize("shape", MESH_SHAPES)
class TestMeshShapes:
    """Every (dp, sp) factorisation must be bit-exact vs unsharded."""

    @pytest.fixture()
    def shaped_mesh(self, shape):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        return make_mesh(8, shape=shape)

    @pytest.mark.parametrize("L", [13, 100])  # uneven lane counts per shard
    def test_decode_all_shapes(self, shaped_mesh, shape, L):
        rng = np.random.default_rng(sum(shape) + L)
        T = 236
        codes = jnp.asarray(rng.integers(0, 16, (L, T)).astype(np.int32))
        si = jnp.asarray(rng.integers(0, 4081, L).astype(np.int32))
        w = jnp.asarray(rng.integers(-20000, 20000, (L, 4)).astype(np.int32))
        h = jnp.asarray(rng.integers(-32768, 32768, (L, 4)).astype(np.int32))
        sharded = decode_blocks_sharded(
            codes, si, w, h, bits_per_sample=4, mesh=shaped_mesh, engine="scan"
        )
        local = decode_blocks(codes, si, w, h, bits_per_sample=4, engine="scan")
        np.testing.assert_array_equal(np.asarray(sharded), np.asarray(local))

    def test_encode_all_shapes(self, shaped_mesh, shape):
        rng = np.random.default_rng(17)
        S, B, C, nspb = 7, 2, 2, 60  # S=7: ragged across every mesh shape
        blocks = jnp.asarray(
            rng.integers(-20000, 20000, (S, B, C, nspb)).astype(np.int32)
        )
        valid = np.full((S, B), nspb, dtype=np.int32)
        valid[:, -1] = 41
        valid = jnp.asarray(valid)
        headers, codes, stat = encode_streams_sharded(
            blocks, valid, bits_per_sample=4, num_trials=1, mesh=shaped_mesh,
            stat=True,
        )
        for s in range(S):
            h_ref, c_ref = encode_stream_blocks(blocks[s], valid[s], 4, 1)
            np.testing.assert_array_equal(np.asarray(codes[s]), np.asarray(c_ref))
            np.testing.assert_array_equal(
                np.asarray(headers.step_index[s]), np.asarray(h_ref.step_index)
            )
        # the stat is a real global reconstruction RMSE; uniform +/-20000
        # noise is the codec's worst case — nonzero and noise-bounded
        assert 0.0 < float(stat) < 0.3


def test_quality_stat_is_reconstruction_rmse():
    """The psum'd statistic equals the host-computed roundtrip RMSE."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from aad_tpu.ops.decode import decode_blocks as db

    mesh = make_mesh(8)
    rng = np.random.default_rng(5)
    S, B, C, nspb = 4, 2, 2, 60
    blocks = jnp.asarray(
        rng.integers(-15000, 15000, (S, B, C, nspb)).astype(np.int32)
    )
    valid = jnp.full((S, B), nspb, dtype=jnp.int32)
    headers, codes, stat = encode_streams_sharded(
        blocks, valid, bits_per_sample=4, num_trials=0, mesh=mesh, stat=True
    )
    recon = db(
        np.asarray(codes).astype(np.uint8),
        headers.step_index,
        headers.weight,
        headers.history,
        bits_per_sample=4,
        engine="scan",
    )
    err = (np.asarray(recon) - np.asarray(blocks)) / 32768.0
    want = float(np.sqrt(np.mean(err**2)))
    assert abs(float(stat) - want) < 1e-6


def test_graft_entry_and_dryrun():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape[-1] == args[0].shape[-1] + 4
    if len(jax.devices()) >= 8:
        g.dryrun_multichip(8)


def test_dryrun_16_devices():
    """16-device mesh: catches any 8-device assumption in make_mesh / shard
    shapes. Runs dryrun_multichip in a child process with a 16-device
    virtual CPU mesh; it asserts sharded == unsharded bit-exactness."""
    import os
    import pathlib
    import re
    import subprocess
    import sys

    env = dict(os.environ)
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                   env.get("XLA_FLAGS", ""))
    env["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=16"
    ).strip()
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(16)"],
        cwd=pathlib.Path(__file__).parent.parent, env=env, check=True,
        timeout=600,
    )


def test_dryrun_refuses_short_backend():
    """dryrun_multichip never substitutes a CPU mesh: asking for more
    devices than the backend has raises."""
    import __graft_entry__ as g

    with pytest.raises(RuntimeError, match="devices requested"):
        g.dryrun_multichip(len(jax.devices()) + 1)


class TestSequenceParallelEncode:
    """Block-independent encode with the block axis sharded over the mesh
    (parallel/sharded.py::encode_blocks_parallel_sharded)."""

    @pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1), (1, 8)])
    def test_matches_unsharded_all_shapes(self, shape):
        from aad_tpu.ops.encode import encode_blocks_parallel
        from aad_tpu.parallel.sharded import encode_blocks_parallel_sharded

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        mesh = make_mesh(8, shape=shape)
        rng = np.random.default_rng(11)
        B, C, nspb = 13, 2, 60  # deliberately not a multiple of mesh size
        blocks = jnp.asarray(
            rng.integers(-20000, 20000, (B, C, nspb)).astype(np.int32)
        )
        valid = np.full(B, nspb, dtype=np.int32)
        valid[-1] = nspb - 7
        jv = jnp.asarray(valid)

        h_s, w_s = encode_blocks_parallel_sharded(
            blocks, jv, bits_per_sample=4, num_trials=2, mesh=mesh
        )
        h_u, w_u = encode_blocks_parallel(blocks, jv, 4, 2)
        np.testing.assert_array_equal(np.asarray(w_s), np.asarray(w_u))
        for a, b in zip(h_s, h_u):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_output_sharding(self):
        from aad_tpu.parallel.sharded import encode_blocks_parallel_sharded

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        mesh = make_mesh(8)
        rng = np.random.default_rng(12)
        B, C, nspb = 16, 2, 60
        blocks = jnp.asarray(
            rng.integers(-20000, 20000, (B, C, nspb)).astype(np.int32)
        )
        valid = jnp.full(B, nspb, dtype=jnp.int32)
        _, words = encode_blocks_parallel_sharded(
            blocks, valid, bits_per_sample=4, num_trials=0, mesh=mesh
        )
        assert len(words.sharding.device_set) == 8

    def test_chunked_matches_unsharded(self):
        """chunk_blocks composes with the mesh: shard boundaries land on
        chunk boundaries, so wp=0 output equals the unsharded call."""
        from aad_tpu.ops.encode import encode_blocks_parallel
        from aad_tpu.parallel.sharded import encode_blocks_parallel_sharded

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        mesh = make_mesh(8)
        rng = np.random.default_rng(13)
        B, C, nspb = 21, 2, 60  # pads to 8*2=16-multiple -> 32
        blocks = jnp.asarray(
            rng.integers(-20000, 20000, (B, C, nspb)).astype(np.int32)
        )
        valid = np.full(B, nspb, dtype=np.int32)
        valid[-1] = nspb - 11
        jv = jnp.asarray(valid)
        h_s, w_s = encode_blocks_parallel_sharded(
            blocks, jv, bits_per_sample=4, num_trials=1, mesh=mesh,
            chunk_blocks=2,
        )
        h_u, w_u = encode_blocks_parallel(
            blocks, jv, 4, 1, chunk_blocks=2
        )
        np.testing.assert_array_equal(np.asarray(w_s), np.asarray(w_u))
        for a, b in zip(h_s, h_u):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.parametrize("c,wp", [(1, 1), (2, 1), (2, 2)])
    def test_warm_ring_matches_unsharded(self, c, wp):
        """Warm passes hand state across shards via a ring ppermute, so
        sharded output is bit-identical to the unsharded warm encode."""
        from aad_tpu.ops.encode import encode_blocks_parallel
        from aad_tpu.parallel.sharded import encode_blocks_parallel_sharded

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        mesh = make_mesh(8)
        rng = np.random.default_rng(17)
        B, C, nspb = 8 * c * 2 + 3, 2, 60  # pad path exercised
        blocks = jnp.asarray(
            rng.integers(-20000, 20000, (B, C, nspb)).astype(np.int32)
        )
        valid = np.full(B, nspb, dtype=np.int32)
        valid[-1] = nspb - 13
        jv = jnp.asarray(valid)
        h_s, w_s = encode_blocks_parallel_sharded(
            blocks, jv, bits_per_sample=4, num_trials=1, mesh=mesh,
            chunk_blocks=c, warm_passes=wp,
        )
        h_u, w_u = encode_blocks_parallel(
            blocks, jv, 4, 1, chunk_blocks=c, warm_passes=wp
        )
        np.testing.assert_array_equal(np.asarray(w_s), np.asarray(w_u))
        for a, b in zip(h_s, h_u):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
