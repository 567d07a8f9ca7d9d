"""The animation drivers (rt_tpu_torch's drivers/animate.py), the frame
farm's split (parallel/distributed.py), video assembly (io/video.py),
the CLI's parse / animate subcommands and render output flags, and
utils/debug.py, against rt_tpu's. Frames are compared with the
outlier-tolerant images_close of tests/conftest.py; the port runs on the
CPU (--device cpu) on the plain engine and on queue (the plain B3)."""

import json
import os
import struct

import numpy as np
import pytest
import torch

from rt_tpu import cli as jcli
from rt_tpu.drivers import animate as janimate
from rt_tpu.io import video as jvideo
from rt_tpu.parallel.distributed import frame_range as jframe_range
from rt_tpu_torch import cli as tcli
from rt_tpu_torch.drivers import animate as tanimate
from rt_tpu_torch.io import video as tvideo
from rt_tpu_torch.io.image import read_png, write_png
from rt_tpu_torch.parallel.distributed import frame_range
from rt_tpu_torch.render import film
from rt_tpu_torch.render import renderer as trenderer
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.assets import readobj
from rt_tpu_torch.utils import debug

# One intra-op thread: the suite runs in several worker processes at
# once (as the other port test files).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "scenes", "demo_scene.json")
PLANE = os.path.join(ROOT, "scenes", "plane441.obj")
SMALL = ["-w", "32", "--height", "18", "-spp", "2", "-d", "4"]
DNA = ["animate", "--kind", "dna", "--frames", "2", "--deg-per-frame", "10"]


def _u8(path):
    return read_png(path).astype(np.float64) / 255.0


@pytest.fixture(scope="module")
def dna_serial(tmp_path_factory):
    """The port's dna frames at 32x18 (queue, the CLI's default engine)."""
    out = str(tmp_path_factory.mktemp("dna_serial"))
    assert tcli.main(DNA + SMALL + ["--outdir", out, "--device",
                                    "cpu"]) == 0
    return out


def test_parse_matches_jax(capsys):
    assert jcli.main(["parse", DEMO]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["parse", DEMO]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert json.loads(got)["objects"] == 7


def test_animate_dna_matches_jax(dna_serial, tmp_path, images_close):
    out = str(tmp_path / "jax")
    assert jcli.main(DNA + SMALL + ["--outdir", out, "--engine",
                                    "xla"]) == 0
    for i in range(2):
        name = f"frame_{i:04d}.png"
        images_close(_u8(os.path.join(dna_serial, name)),
                     _u8(os.path.join(out, name)), spp=1)


def test_animate_dolly_matches_jax(tmp_path, images_close):
    args = ["animate", "--kind", "dolly", "--frames", "2", "--start", "3",
            "-w", "24", "--height", "24", "-spp", "2", "-d", "3"]
    assert jcli.main(args + ["--outdir", str(tmp_path / "j"), "--engine",
                             "xla"]) == 0
    assert tcli.main(args + ["--outdir", str(tmp_path / "t"), "--engine",
                             "plain", "--device", "cpu"]) == 0
    for i in (3, 4):
        name = f"dolly_{i:04d}.png"
        images_close(_u8(str(tmp_path / "t" / name)),
                     _u8(str(tmp_path / "j" / name)), spp=1)


def test_animate_blue_scene_json_matches_jax(tmp_path, monkeypatch):
    """The per-frame scene JSON of blue (every cylinder's angle advanced
    by deg_per_frame * i) equals rt_tpu's; the JSON is written before the
    frame renders, so rt_tpu's render is skipped here. A rerun skips the
    frames on disk."""
    args = ["animate", "--kind", "blue", "--scene", DEMO, "--frames", "2",
            "--deg-per-frame", "15"] + SMALL
    monkeypatch.setattr(janimate, "_render_frame", lambda *a, **k: None)
    assert jcli.main(args + ["--outdir", str(tmp_path / "j"), "--engine",
                             "xla"]) == 0
    tdir = tmp_path / "t"
    assert tcli.main(args + ["--outdir", str(tdir), "--device", "cpu",
                             "--engine", "plain"]) == 0
    for i in range(2):
        name = f"scene_{i:04d}.json"
        got = json.loads((tdir / name).read_text())
        assert got == json.loads((tmp_path / "j" / name).read_text())
        assert (tdir / f"frame_{i:04d}.png").exists()
    angles = [o["rotate"]["angle"] for o in json.loads(
        (tdir / "scene_0001.json").read_text())["object"]["data"]
        if o.get("type") == "cylinder"]
    assert angles == [90 + 15]
    stamp = (tdir / "frame_0000.png").stat().st_mtime_ns
    assert tcli.main(args + ["--outdir", str(tdir), "--device", "cpu",
                             "--engine", "plain"]) == 0
    assert (tdir / "frame_0000.png").stat().st_mtime_ns == stamp


def test_animate_points_jpg(tmp_path):
    """points on per-frame point files made with numpy from
    scenes/plane441.obj (a wave through the cloth), written as JPEG."""
    verts, _, _ = readobj(PLANE)
    pdir = tmp_path / "points"
    pdir.mkdir()
    for i in range(2):
        pts = verts.copy()
        pts[:, 1] += 0.3 * i * np.sin(3.0 * verts[:, 0])
        np.savetxt(str(pdir / f"{i + 1}.txt"), pts, fmt="%.6f")
    out = tmp_path / "frames"
    assert tcli.main(["animate", "--kind", "points", "--obj", PLANE,
                      "--points-dir", str(pdir), "--frames", "2", "-w", "32",
                      "--height", "18", "-spp", "1", "-d", "2", "--engine",
                      "plain", "--format", "jpg", "--outdir", str(out),
                      "--device", "cpu"]) == 0
    from PIL import Image

    imgs = [np.asarray(Image.open(str(out / f"out{i}.jpg")))
            for i in range(2)]
    assert all(im.shape == (18, 32, 3) for im in imgs)
    assert not np.array_equal(imgs[0], imgs[1])


def test_frame_range_matches_jax():
    for frames in (1, 4, 7, 10):
        for hosts in (1, 2, 3, 5):
            for idx in range(hosts):
                for start in (0, 5):
                    assert frame_range(frames, hosts, idx, start) == \
                        jframe_range(frames, hosts, idx, start)
    covered = [f for h in range(3) for f in range(*frame_range(10, 3, h, 5))]
    assert covered == list(range(5, 15))
    for bad in (3, -1):
        with pytest.raises(ValueError):
            frame_range(10, 3, bad)


def test_farm_frames_equal_serial_and_video(dna_serial, tmp_path):
    """--farm 2 --device cpu: two worker processes render disjoint slices,
    byte-equal to the serial run's frames; --video assembles an MJPEG
    AVI (no ffmpeg needed) whose index references both frames."""
    out = str(tmp_path / "farm")
    video = str(tmp_path / "anim.avi")
    assert tcli.main(DNA + SMALL + ["--outdir", out, "--farm", "2",
                                    "--device", "cpu", "--video",
                                    video]) == 0
    for i in range(2):
        name = f"frame_{i:04d}.png"
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(dna_serial, name), "rb") as b:
            assert a.read() == b.read()
    data = open(video, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    assert data.count(b"00dc") >= 4  # 2 movi chunks + 2 idx1 entries


def test_mjpeg_avi_matches_jax(dna_serial, tmp_path):
    """write_mjpeg_avi byte-equal to rt_tpu's on the same JPEG bytes (an
    odd length, so the even padding shows), and assemble_video of the same
    frames."""
    fake = b"\xff\xd8\xff\xe0" + b"x" * 33 + b"\xff\xd9"
    tvideo.write_mjpeg_avi(str(tmp_path / "t.avi"), [fake, fake, fake], 8,
                           6, fps=10)
    jvideo.write_mjpeg_avi(str(tmp_path / "j.avi"), [fake, fake, fake], 8,
                           6, fps=10)
    assert (tmp_path / "t.avi").read_bytes() == \
        (tmp_path / "j.avi").read_bytes()
    frames = [os.path.join(dna_serial, f"frame_{i:04d}.png")
              for i in (1, 0)]
    got = tvideo.assemble_video(frames, str(tmp_path / "t2.mp4"), fps=12)
    want = jvideo.assemble_video(frames, str(tmp_path / "j2.mp4"), fps=12)
    assert os.path.basename(got)[1:] == os.path.basename(want)[1:]
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError):
        tvideo.assemble_video([], str(tmp_path / "none.avi"))


@pytest.fixture(scope="module")
def small():
    sdef, cfg = tbuilders.three_sphere_scene(width=24, height=16, spp=2,
                                             max_depth=3)
    return ttypes.build_tables(sdef), cfg.replace(engine="plain")


def test_frame_pipeline_matches_sync(small, tmp_path):
    """FramePipeline writes the same PNGs as the synchronous path,
    including the frame the last flush writes."""
    tables, cfg = small
    pipe = tanimate.FramePipeline("cpu")
    for i in range(3):
        c = cfg.replace(seed=i)
        prev = pipe.submit(tables, c, str(tmp_path / f"pipe_{i}.png"))
        if i == 0:
            assert prev is None
        else:
            assert prev[0].endswith(f"pipe_{i - 1}.png") and prev[1] >= 0.0
        write_png(str(tmp_path / f"sync_{i}.png"), film.finalize(
            trenderer.render(tables, c, device="cpu"), 2, gamma=True))
    assert pipe.flush()[0].endswith("pipe_2.png")
    assert pipe.flush() is None
    for i in range(3):
        assert (tmp_path / f"pipe_{i}.png").read_bytes() == \
            (tmp_path / f"sync_{i}.png").read_bytes()


def test_frame_pipeline_failure_keeps_frame_pending(small, tmp_path,
                                                    monkeypatch):
    """A frame whose download and synchronous re-render both fail stays
    pending (the error propagates, the frame is not dropped); once the
    fault clears, the next flush writes it."""
    tables, cfg = small
    pipe = tanimate.FramePipeline("cpu")
    p = tmp_path / "f0.png"
    assert pipe.submit(tables, cfg, str(p)) is None

    def poison():
        raise RuntimeError("download failed")

    pipe._pending = (poison, *pipe._pending[1:])
    real = trenderer.render

    def broken(*a, **k):
        raise RuntimeError("device failed")

    monkeypatch.setattr(trenderer, "render", broken)
    with pytest.raises(RuntimeError, match="device failed"):
        pipe.flush()
    assert pipe._pending is not None and not p.exists()
    monkeypatch.setattr(trenderer, "render", real)
    done = pipe.flush()  # the synchronous re-render succeeds now
    assert done[0].endswith("f0.png") and p.exists()
    assert pipe.flush() is None
    want = film.finalize(real(tables, cfg, device="cpu"), 2, gamma=True)
    np.testing.assert_array_equal(read_png(str(p)), want)


def test_render_output_flags(tmp_path):
    """--both-formats writes the .ppm and the .png of one render,
    --view-gamma puts sqrt gamma in the PNG, --log gets one RenderStats
    line, and a .jpg output is JPEG."""
    from rt_tpu_torch.scene.builders import three_sphere_scene

    log = tmp_path / "L.log"
    base = ["render", "--coded", "three_sphere", "-w", "24", "--height",
            "16", "-spp", "2", "-d", "3", "--engine", "plain", "--device",
            "cpu", "--log", str(log)]
    assert tcli.main(base + ["-o", str(tmp_path / "a.png"),
                             "--both-formats", "--view-gamma"]) == 0
    sdef, cfg = three_sphere_scene(width=24, height=16, spp=2, max_depth=3)
    img = trenderer.render(ttypes.build_tables(sdef),
                           cfg.replace(engine="plain"), device="cpu")
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")),
                                  film.finalize(img, 2, gamma=True))
    assert (tmp_path / "a.ppm").read_text() == film.to_ppm(img, 2)
    lines = log.read_text().splitlines()
    assert len(lines) == 1 and lines[0].startswith(
        "rt_tpu_torch, width 24 height 16 spp 2 depth 3 engine plain")
    assert tcli.main(base + ["-o", str(tmp_path / "b.jpg")]) == 0
    assert (tmp_path / "b.jpg").read_bytes()[:2] == b"\xff\xd8"
    assert len(log.read_text().splitlines()) == 2


@pytest.mark.parametrize("flag,queue", [("--bvh", None),
                                        ("--sharded", "A-9")])
def test_render_unported_flags_raise(flag, queue, tmp_path):
    """Flags that once refused: --bvh renders (its frames:
    tests/test_torch_bvh_cli.py); --sharded (ROADMAP item A-9) without
    torchrun is a world of one, whose frame on queue is the unsharded
    render's bit for bit (tests/test_torch_parallel.py runs it over 2
    torchrun ranks)."""
    args = ["render", "--device", "cpu", "-w", "16", "--height", "9",
            "-spp", "1", "-d", "2", "--log", str(tmp_path / "t.log")]
    assert tcli.main(args + [flag, "-o", str(tmp_path / "a.png")]) == 0
    assert (tmp_path / "a.png").exists()
    if queue is None:
        return
    assert tcli.main(args + ["-o", str(tmp_path / "b.png")]) == 0
    a, b = read_png(str(tmp_path / "a.png")), read_png(str(tmp_path / "b.png"))
    assert a.max() > 0
    np.testing.assert_array_equal(a, b)


def test_assert_finite_names_the_field():
    debug.assert_finite({"a": np.ones(3), "b": torch.ones(2)})
    with pytest.raises(FloatingPointError, match=r"value\['a'\]"):
        debug.assert_finite({"a": np.array([1.0, np.nan])})
    sdef, _ = tbuilders.three_sphere_scene(spp=1)
    tables = ttypes.build_tables(sdef)
    debug.assert_finite(tables, "tables")
    bad = ttypes.SceneTables(**{
        **{f: getattr(tables, f) for f in tables.__dataclass_fields__},
        "mat_fuzz": tables.mat_fuzz.clone().fill_(float("inf"))})
    with pytest.raises(FloatingPointError, match=r"tables\.mat_fuzz"):
        debug.assert_finite(bad, "tables")


def test_replay_determinism(small):
    tables, cfg = small
    assert debug.replay_check(trenderer.render, tables, cfg, device="cpu")
    calls = iter([torch.zeros(2), torch.ones(2)])
    assert not debug.replay_check(lambda: next(calls))


def test_checked_intersect():
    """A clean batch passes and reports the hit; a NaN ray and an object
    row outside its table raise."""
    sdef, _ = tbuilders.three_sphere_scene(spp=1)
    tables = ttypes.build_tables(sdef)
    ro = torch.zeros((8, 3)) + torch.tensor([0.0, 0.0, 1.0])
    rd = torch.zeros((8, 3)) + torch.tensor([0.0, 0.0, -1.0])
    hit = debug.checked_intersect(tables, ro, rd)
    assert bool(hit.hit[0])
    with pytest.raises(FloatingPointError):
        debug.checked_intersect(tables, ro, rd * float("nan"))
    bad = ttypes.SceneTables(**{
        **{f: getattr(tables, f) for f in tables.__dataclass_fields__},
        "sph_mat": tables.sph_mat + 100})
    with pytest.raises(IndexError, match="material"):
        debug.checked_intersect(bad, ro, rd)
    with debug.nan_debug():
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()
