"""Extended differential soak: our engines vs the reference binary, direct.

Random geometries, both directions, N seeds (default 400, ~6 min). Scales
up the suite's tests/test_native.py::TestGeometryFuzz (6 seeds per run)
for pre-release confidence sweeps. The sampled space spans the FORMAT's
limits, not just the common operating points (round-5 widening):

* max_block_size: ~15% near-minimum blocks (header + 0-2 pack units,
  including header-only), ~70% the production band [40*nch, 1200), ~15%
  log-uniform up to the wire field's u16 ceiling 65535 (header write
  reference: src/aad_encoder.c:188-217);
* trials: biased to the reference CLI band {0,1,2}, with a ~25% tail
  drawn from [3, 8] — deeper searches shift the min-RMSE fold's
  selection (trial loop reference: src/aad_encoder.c:470-562);
* every ``DEPTH_EVERY``-th seed runs file-level ingest conformance at a
  random 8/24/32-bit WAV depth (ingest truncation reference:
  src/main.c:177) — our encode_file vs the reference CLI on the same
  file, byte-exact.

Most seeds run the fast native engine; every ``JAX_EVERY``-th seed ALSO
puts the JAX scan engines face-to-face with the reference binary (encode
bytes and decoded samples, no native transitivity), and every
``FUSED_EVERY``-th seed additionally decodes through the fused engine
(Pallas interpret on CPU — slow, so sparse). The final line reports
per-engine seed counts.

Usage: python tools/soak_fuzz.py [num_seeds] [--record PATH]

``--record`` writes a JSON artifact ({seeds, divergences, per-engine seed
counts, seconds}) so a round's soak run is auditable from the repo, not
just from the progress log.

Exit 0 iff every compared byte/sample matches the reference binary
(reference: src/aad_encoder.c:85-131 interleave geometry,
src/aad_encoder.c:470-562 trial search, src/aad_decoder.c:394-455 block
data walk). Seed space (50_000+) is disjoint from the suite's (1000+).
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO))
sys.path.insert(0, str(_REPO / "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
from util import reference_decode, reference_encode, write_pcm16_wav

from aad_tpu import native
from aad_tpu.codec.decoder import decode as jax_decode
from aad_tpu.codec.result import AadError
from aad_tpu.codec.encoder import EncodeConfig
from aad_tpu.codec.encoder import encode as jax_encode
from aad_tpu.format.wav import read_wav

REFERENCE_DIR = Path(os.environ.get("AAD_TPU_REFERENCE_DIR", "/root/reference"))

# Direct JAX-engine seeds: every Nth seed compares the scan engines (and,
# sparser, fused-interpret decode) straight against the reference binary —
# a shared native+JAX misreading of the geometry helpers cannot pass.
JAX_EVERY = 8
FUSED_EVERY = 64
DEPTH_EVERY = 16  # file-level ingest conformance at 8/24/32-bit WAV depth


def _draw_geometry(rng, nch: int, bps: int):
    """max_block_size spanning the format's limits (round-5 widening)."""
    from aad_tpu.constants import block_header_size

    r = rng.random()
    hdr = block_header_size(nch)
    if r < 0.15:
        # near-minimum: header + a handful of bytes (may be header-only —
        # every sample lives in the 4-tap history, nspb == 4)
        return int(rng.integers(hdr, hdr + 60))
    if r < 0.85:
        return int(rng.integers(40 * nch, 1200))
    # log-uniform up to the u16 wire-field ceiling
    lo, hi = np.log(1200.0), np.log(65535.0)
    return int(np.exp(rng.uniform(lo, hi)))


def _draw_trials(rng) -> int:
    """Biased to the CLI band {0,1,2}; ~25% deep searches in [3, 8]."""
    if rng.random() < 0.75:
        return int(rng.integers(0, 3))
    return int(rng.integers(3, 9))


def main(n_seeds: int = 400, record: str | None = None) -> int:
    t_start = time.time()
    if not REFERENCE_DIR.is_dir() or shutil.which("gcc") is None:
        print("reference sources or gcc unavailable; nothing to soak against")
        return 2
    build = Path(tempfile.mkdtemp(prefix="refsoak"))
    shutil.copytree(REFERENCE_DIR / "src", build / "src")
    shutil.copy(REFERENCE_DIR / "Makefile", build / "Makefile")
    subprocess.run(["make", "-s"], cwd=build, check=True, timeout=120)
    binary = build / "aad"
    work = build / "work"
    work.mkdir()

    def _shed_jit_maps() -> None:
        # Random geometries mean every JAX oracle seed compiles fresh shapes;
        # live JIT code mappings accumulate and a long soak in one process
        # can hit the kernel vm.max_map_count ceiling (65530 — the same
        # failure mode tests/conftest.py guards against). Shed executables
        # periodically; functools-cached probe results survive.
        try:
            with open("/proc/self/maps") as f:
                high = sum(1 for _ in f) > 40_000
        except OSError:
            return
        if high:
            import gc

            import jax

            jax.clear_caches()
            gc.collect()

    bad = 0
    counts = {"native": 0, "scan": 0, "fused": 0, "depth": 0,
              "reject_parity": 0, "ref_cli_overflow": 0}
    deep_trials = big_blocks = tiny_blocks = 0
    for seed in range(n_seeds):
        if seed % JAX_EVERY == 0:
            _shed_jit_maps()
        rng = np.random.default_rng(50_000 + seed)
        nch = int(rng.integers(1, 3))
        bps = int(rng.integers(2, 5))
        mbs = _draw_geometry(rng, nch, bps)
        ms = int(rng.integers(0, 2)) if nch == 2 else 0
        trials = _draw_trials(rng)
        deep_trials += trials > 2
        big_blocks += mbs >= 1200
        tiny_blocks += mbs < 40 * nch
        cfg = EncodeConfig(
            num_channels=nch, sampling_rate=8000, bits_per_sample=bps,
            max_block_size=mbs, ch_process_method=ms,
            num_encode_trials=trials,
        )
        nspb = cfg.geometry().num_samples_per_block
        # big blocks: 1.5 blocks still covers a ragged second block without
        # blowing the JAX oracle seeds' runtime on six-figure nspb
        n_hi = 5 * nspb + 2 if nspb <= 8192 else (3 * nspb) // 2 + 2
        n = int(rng.integers(1, n_hi))
        # mix full-scale noise (the wrapped-square accumulator regime —
        # docs/DESIGN.md §3 exact-RMSE selection) with quieter signals
        scale = [32768, 32768, 8192, 512][seed % 4]
        pcm = rng.integers(-scale, scale, (nch, n)).astype(np.int32)

        wav = work / f"s{seed}.wav"
        write_pcm16_wav(wav, pcm, 8000)
        try:
            ours = native.encode(pcm, cfg)
        except AadError:
            # near-minimum geometries can leave zero interleave units per
            # block, which the reference rejects at header-encode time
            # (src/aad_encoder.c:170). Parity here means BOTH sides
            # reject — a config we refuse but the reference accepts (or
            # vice versa) is a divergence.
            rc = subprocess.run(
                [str(binary), "-e", "-b", str(bps), "-s", str(mbs),
                 "-t", str(trials)] + (["-m"] if ms else [])
                + [str(wav), str(work / f"s{seed}.aad")],
                capture_output=True, timeout=120,
            ).returncode
            # Parity means the reference REJECTS CLEANLY (positive exit
            # code). rc == 0 (it accepts) and rc < 0 (it accepted the
            # config far enough to crash while encoding) are both
            # divergences from our rejection.
            if rc <= 0:
                bad += 1
                print(f"REJECTION DIVERGENCE seed={seed} cfg={cfg}: "
                      f"we reject, reference rc={rc}")
            counts["reject_parity"] += 1
            for f in work.iterdir():
                f.unlink()
            continue
        counts["native"] += 1
        try:
            ref = reference_encode(binary, wav, work / f"s{seed}.aad",
                                   bps=bps, block=mbs, trials=trials,
                                   ms=ms == 1)
        except subprocess.CalledProcessError as e:
            # The reference CLI sizes its OUTPUT buffer as the input WAV's
            # file size (src/main.c:171-172) and heap-overflows whenever
            # the encoded stream is larger — any stream tiny enough that
            # 31 + 36*blocks exceeds the WAV (found by this round's
            # near-minimum-block widening; aborts as "double free or
            # corruption" or segfaults outright depending on how far the
            # write lands). Verify that precondition so an unexpected
            # crash cannot hide here, then fall back to the reference
            # DECODER as oracle: it sizes from the header and must accept
            # our bytes and reproduce our samples exactly.
            if e.returncode not in (-6, -11) or len(ours) <= wav.stat().st_size:
                raise
            counts["ref_cli_overflow"] += 1
            (work / f"o{seed}.aad").write_bytes(ours)
            ref_wav = reference_decode(binary, work / f"o{seed}.aad",
                                       work / f"o{seed}_dec.wav")
            _, ref_pcm = read_wav(str(ref_wav))
            _, dec = native.decode(ours)
            if not np.array_equal(np.asarray(dec), ref_pcm >> 16):
                bad += 1
                print(f"OVERFLOW-SEED DECODE DIVERGENCE seed={seed} "
                      f"cfg={cfg}")
            for f in work.iterdir():
                f.unlink()
            continue
        if ours != ref:
            bad += 1
            print(f"ENCODE DIVERGENCE seed={seed} cfg={cfg}")
            continue
        _, dec = native.decode(ours)
        ref_wav = reference_decode(binary, work / f"s{seed}.aad",
                                   work / f"s{seed}_dec.wav")
        _, ref_pcm = read_wav(str(ref_wav))
        if not np.array_equal(np.asarray(dec), ref_pcm >> 16):
            bad += 1
            print(f"DECODE DIVERGENCE seed={seed} cfg={cfg}")
            continue

        # direct JAX-engine oracle seeds: reference binary on one side,
        # the scan engines (no native in the loop) on the other
        if seed % JAX_EVERY == 0:
            counts["scan"] += 1
            jenc = jax_encode(pcm, cfg, engine="scan")
            if jenc != ref:
                bad += 1
                print(f"JAX-ENCODE DIVERGENCE seed={seed} cfg={cfg}")
                continue
            _, jdec = jax_decode(ref, engine="scan")
            if not np.array_equal(np.asarray(jdec), ref_pcm >> 16):
                bad += 1
                print(f"JAX-DECODE DIVERGENCE seed={seed} cfg={cfg}")
                continue
        if seed % FUSED_EVERY == 0 and nspb <= 8192:
            # interpret-mode fused decode is minutes-slow on six-figure
            # nspb; the GPU suite covers big geometries compiled
            counts["fused"] += 1
            _, fdec = jax_decode(ref, engine="fused_interpret")
            if not np.array_equal(np.asarray(fdec), ref_pcm >> 16):
                bad += 1
                print(f"FUSED-DECODE DIVERGENCE seed={seed} cfg={cfg}")
                continue

        # file-level ingest conformance at non-16-bit WAV depths: the
        # reference truncates canonical PCM to 16 bits on ingest
        # (src/main.c:177); encode_file mirrors it — bytes must match.
        if seed % DEPTH_EVERY == 5:
            from aad_tpu.format.wav import WavFormat, write_wav
            from aad_tpu.io import encode_file

            depth = [8, 24, 32][(seed // DEPTH_EVERY) % 3]
            counts["depth"] += 1
            canonical = (
                rng.integers(
                    -(2 ** (depth - 1)), 2 ** (depth - 1), (nch, n),
                    dtype=np.int64,
                )
                << (32 - depth)
            ).astype(np.int32)
            dwav = work / f"d{seed}.wav"
            write_wav(str(dwav), WavFormat(
                num_channels=nch, sampling_rate=8000,
                bits_per_sample=depth, num_samples=n,
            ), canonical)
            encode_file(
                str(dwav), str(work / f"d{seed}_ours.aad"),
                bits_per_sample=bps, max_block_size=mbs, ms=ms == 1,
                num_encode_trials=trials, engine="native",
            )
            d_ours = (work / f"d{seed}_ours.aad").read_bytes()
            try:
                dref = reference_encode(
                    binary, dwav, work / f"d{seed}.aad", bps=bps,
                    block=mbs, trials=trials, ms=ms == 1,
                )
            except subprocess.CalledProcessError as e:
                # same output-buffer overflow as above, at another depth
                if (e.returncode not in (-6, -11)
                        or len(d_ours) <= dwav.stat().st_size):
                    raise
                counts["ref_cli_overflow"] += 1
            else:
                if d_ours != dref:
                    bad += 1
                    print(f"DEPTH-INGEST DIVERGENCE seed={seed} "
                          f"depth={depth} cfg={cfg}")
                    continue

        # block-parallel conformance: the framework's own mode must emit a
        # stream the REFERENCE decoder accepts and that our decoder reads
        # identically (the "every block a stream head" validity claim,
        # reference: src/aad_decoder.c:363-380 per-block state load)
        cb = int(rng.integers(1, 4))
        wp = int(rng.integers(0, 3))
        par = native.encode_parallel(pcm, cfg, chunk_blocks=cb,
                                     warm_passes=wp)
        (work / f"p{seed}.aad").write_bytes(par)
        ref_pwav = reference_decode(binary, work / f"p{seed}.aad",
                                    work / f"p{seed}_dec.wav")
        _, ref_ppcm = read_wav(str(ref_pwav))
        _, pdec = native.decode(par)
        if not np.array_equal(np.asarray(pdec), ref_ppcm >> 16):
            bad += 1
            print(f"PARALLEL-STREAM DIVERGENCE seed={seed} c={cb} wp={wp} "
                  f"cfg={cfg}")
        for f in work.iterdir():
            f.unlink()
        if (seed + 1) % 50 == 0:
            print(f"{seed + 1}/{n_seeds} ok so far (divergences: {bad})",
                  flush=True)

    print(
        f"soak done: {n_seeds} seeds, {bad} divergences; per-engine seeds: "
        f"native={counts['native']} scan={counts['scan']} "
        f"fused={counts['fused']} depth-ingest={counts['depth']} "
        f"reject-parity={counts['reject_parity']} "
        f"ref-cli-overflow={counts['ref_cli_overflow']} "
        f"(scan/fused compared DIRECTLY against the reference binary); "
        f"space: deep-trials(3-8)={deep_trials} "
        f"big-blocks(>=1200)={big_blocks} near-min-blocks={tiny_blocks}"
    )
    if record:
        Path(record).write_text(json.dumps({
            "seeds": n_seeds,
            "divergences": bad,
            "engine_seeds": counts,
            "space": {
                "trials": "{0,1,2} 75% / [3,8] 25%",
                "deep_trial_seeds": deep_trials,
                "max_block_size": "15% [hdr, hdr+60) / 70% [40*nch, 1200)"
                                  " / 15% log-uniform [1200, 65535]",
                "big_block_seeds": big_blocks,
                "near_min_block_seeds": tiny_blocks,
                "wav_depth_seeds": counts["depth"],
            },
            "seconds": round(time.time() - t_start, 1),
            "ok": bad == 0,
        }, indent=1) + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    rec = None
    if "--record" in argv:
        i = argv.index("--record")
        rec = argv[i + 1]
        del argv[i : i + 2]
    sys.exit(main(int(argv[0]) if argv else 400, record=rec))
