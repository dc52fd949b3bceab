"""The port's streaming input pipeline, codecs and readers against the JAX
package's, on the CPU.

The same BMP / PNG files (made from a seed) go through both packages'
``FileSource -> shuffle -> decode -> map -> batch -> repeat`` chains and
readers; every record, batch and ``state_dict`` must be EQUAL (host code on
both sides: there is no rounding to allow for). A snapshot taken by either
package resumes in the other. The native codec is held only where it
builds (``native_available()``).
"""
import json
import os
import struct
import zipfile
import zlib

import numpy as np
import pytest
import torch

from mmlspark_tpu import data as jdata
from mmlspark_tpu.core.frame import Frame as JFrame
from mmlspark_tpu.image.transformer import ImageTransformer as JImageTransformer
from mmlspark_tpu.io import codecs as jcodecs
from mmlspark_tpu.io import readers as jreaders
from mmlspark_tpu.reliability import faults as jfaults
from mmlspark_tpu_torch import data as tdata
from mmlspark_tpu_torch.core.frame import Frame
from mmlspark_tpu_torch.core.schema import ColumnSchema, DType
from mmlspark_tpu_torch.image.transformer import ImageTransformer
from mmlspark_tpu_torch.io import codecs as tcodecs
from mmlspark_tpu_torch.io import readers as treaders
from mmlspark_tpu_torch.observability import metrics as tmetrics
from mmlspark_tpu_torch.parallel.optim import sgd
from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
from mmlspark_tpu_torch.reliability import faults as tfaults
from mmlspark_tpu_torch.utils import config as tconfig
from mmlspark_tpu_torch.utils import native_loader

PACKAGES = {"jax": (jdata, jcodecs, jreaders, jfaults),
            "port": (tdata, tcodecs, treaders, tfaults)}


@pytest.fixture(autouse=True)
def on_cpu():
    tconfig.set("runtime.device", "cpu")
    yield
    tconfig.unset("runtime.device")


def _images(n, hw=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8)
            for _ in range(n)]


@pytest.fixture
def corpus(tmp_path):
    """20 labelled images, alternately BMP and PNG, plus one undecodable
    file and a zip of 6 more PNGs."""
    root = tmp_path / "corpus"
    root.mkdir()
    imgs = _images(26, seed=3)
    for i, img in enumerate(imgs[:20]):
        enc, ext = ((jcodecs.encode_bmp, "bmp") if i % 2
                    else (jcodecs.encode_png, "png"))
        (root / f"{i:03d}_{i % 4}.{ext}").write_bytes(enc(img))
    (root / "zz_broken.png").write_bytes(b"\x89PNG\r\n\x1a\nnot a png")
    with zipfile.ZipFile(root / "more.zip", "w") as z:
        for i, img in enumerate(imgs[20:]):
            z.writestr(f"inner/{i:03d}_{i % 4}.png", jcodecs.encode_png(img))
    return str(root)


def _to_row(rec):
    label = int(os.path.basename(rec["path"]).split("_")[1].split(".")[0])
    return {"image": rec["image"].reshape(-1), "label": label,
            "path": rec["path"]}


def _chain(pkg, root, remainder="drop", epochs=2, window=7, workers=2):
    data = PACKAGES[pkg][0]
    return (data.FileSource(root, inspect_zip=True)
            .shuffle(window=window, seed=5)
            .decode(workers=workers, chunk=3)
            .map(_to_row)
            .batch(4, remainder=remainder)
            .repeat(epochs))


def _equal_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            assert g[k].shape == w[k].shape, k
            if w[k].dtype == np.object_:
                assert list(g[k]) == list(w[k]), k
            else:
                np.testing.assert_array_equal(g[k], w[k])


def _drain(it):
    with it:
        return list(it)


# -- the stream, record for record and batch for batch ------------------------

@pytest.mark.parametrize("remainder", ["drop", "pad", "keep"])
def test_stream_equals_the_jax_package_batch_for_batch(corpus, remainder):
    """shuffle (window 7, seed 5), decode (2 workers, chunks of 3; the
    broken file drops), the zip's members, the three remainders, repeat(2):
    every batch equal, and the state_dict after every batch key-for-key
    equal."""
    t_it = _chain("port", corpus, remainder).iter()
    j_it = _chain("jax", corpus, remainder).iter()
    got, want = [], []
    with t_it, j_it:
        for g, w in zip(t_it, j_it):
            got.append(g)
            want.append(w)
            assert t_it.state_dict() == j_it.state_dict()
        assert next(t_it, None) is None and next(j_it, None) is None
    _equal_batches(got, want)
    # 26 decodable images a pass (20 files and the zip's 6), two passes
    per_epoch = [len(b["label"]) for b in got[:len(got) // 2]]
    assert sum(per_epoch) == {"drop": 24, "pad": 28, "keep": 26}[remainder]
    if remainder == "pad":
        assert got[-1]["weight"].tolist() == [1.0, 1.0, 0.0, 0.0]


def test_multi_hot_and_padding_equal_the_jax_package(tmp_path):
    """Ragged id lists (made from a seed) padded and truncated to 4 slots
    with their weight masks, under remainder 'pad'."""
    root = tmp_path / "ids"
    root.mkdir()
    rng = np.random.default_rng(2)
    for i in range(11):
        ids = rng.integers(1, 100, rng.integers(0, 7)).astype(np.int64)
        (root / f"r{i:02d}.bin").write_bytes(ids.tobytes())

    def parse(rec):
        return {"ids": np.frombuffer(rec["bytes"], np.int64),
                "n": len(rec["bytes"]) // 8}

    def chain(data):
        return (data.FileSource(str(root)).map(parse)
                .batch(3, remainder="pad", multi_hot={"ids": 4}))
    _equal_batches(_drain(chain(tdata).iter()), _drain(chain(jdata).iter()))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("at", [1, 5, 8, 12])
def test_a_snapshot_resumes_in_the_other_package(corpus, direction, at):
    """Take ``state_dict`` after ``at`` batches in one package (through a
    JSON round trip, as the checkpointer stores it), load it into a fresh
    iterator of the other: the rest of the stream equals the uninterrupted
    stream's tail."""
    src, dst = ("jax", "port") if direction == "jax_to_port" \
        else ("port", "jax")
    full = _drain(_chain(dst, corpus, "pad").iter())
    with _chain(src, corpus, "pad").iter() as it:
        for _ in range(at):
            next(it)
        snap = json.loads(json.dumps(it.state_dict()))
    resumed = _chain(dst, corpus, "pad").iter()
    resumed.load_state_dict(snap)
    _equal_batches(_drain(resumed), full[at:])


def test_file_source_resume_requires_the_same_listing(corpus, tmp_path):
    it = tdata.FileSource(corpus).iter()
    next(it)
    snap = it.state_dict()
    os.remove(os.path.join(corpus, "000_0.png"))
    with pytest.raises(ValueError, match="listing changed"):
        tdata.FileSource(corpus).iter().load_state_dict(snap)


def test_stage_constructors_validate_like_the_jax_package():
    src = tdata.FileSource(".")
    for bad in (lambda d: d.FileSource(".", sample_ratio=0.0),
                lambda d: d.ShuffleBuffer(src, window=0),
                lambda d: d.ParallelDecode(src, workers=0),
                lambda d: d.ParallelDecode(src, chunk=0),
                lambda d: d.Batcher(src, 0),
                lambda d: d.Batcher(src, 2, remainder="nope"),
                lambda d: d.Batcher(src, 2, multi_hot={"x": 0}),
                lambda d: d.Repeat(src, epochs=0)):
        for pkg in (tdata, jdata):
            with pytest.raises(ValueError):
                bad(pkg)


def test_fault_sites_and_drop_counter_match_the_jax_package(corpus):
    """The data.list / data.shuffle / data.decode / readers.read sites are
    hit the same number of times in both packages, and the broken file
    counts in data.decode_dropped."""
    hits = {}
    for pkg in ("jax", "port"):
        faults = PACKAGES[pkg][3]
        with faults.FaultPlan() as plan:
            _drain(_chain(pkg, corpus, "keep", epochs=1).iter())
        hits[pkg] = dict(plan.hits)
    assert hits["port"] == hits["jax"]
    assert hits["port"]["data.decode"] == 27
    before = tmetrics.counter("data.decode_dropped").value
    _drain(_chain("port", corpus, "keep", epochs=1).iter())
    assert tmetrics.counter("data.decode_dropped").value == before + 1


def test_injected_decode_fault_then_resume_replays_the_stream(corpus):
    """A fault at the 9th record's decode: resuming from the snapshot of
    the last delivered batch gives the uninterrupted stream's tail."""
    full = _drain(_chain("port", corpus, "drop").iter())
    it = _chain("port", corpus, "drop").iter()
    got, snap = [], None
    with tfaults.FaultPlan(tfaults.FaultSpec("data.decode", on_hit=40)):
        with pytest.raises(tfaults.InjectedFault):
            for b in it:
                got.append(b)
                snap = it.state_dict()
    it.close()
    resumed = _chain("port", corpus, "drop").iter()
    resumed.load_state_dict(snap)
    _equal_batches(got + _drain(resumed), full)


def test_trainer_fit_accepts_a_dataset():
    """``fit`` builds a Dataset's iterator and closes it: the same losses
    and parameters as the materialized list of its batches."""
    rng = np.random.default_rng(0)
    rows = [{"x": rng.normal(size=4).astype(np.float32),
             "y": np.float32(i % 3)} for i in range(32)]

    class Rows(tdata.Dataset):
        def iter(self, epoch=0):
            return _RowsIter()

    class _RowsIter(tdata.PipelineIterator):
        def __init__(self):
            self.i = 0

        def __next__(self):
            if self.i >= len(rows):
                raise StopIteration
            self.i += 1
            return rows[self.i - 1]

        def state_dict(self):
            return {"i": self.i}

        def load_state_dict(self, state):
            self.i = int(state["i"])

    def loss(module, batch, gen):
        return ((module(batch["x"])[:, 0] - batch["y"]) ** 2).mean()

    def init():
        torch.manual_seed(0)
        return torch.nn.Linear(4, 1)
    ds = Rows().batch(8)
    t1 = DistributedTrainer(loss, sgd(0.1))
    s1, l1 = t1.fit(t1.init(init), ds)
    t2 = DistributedTrainer(loss, sgd(0.1))
    s2, l2 = t2.fit(t2.init(init), _drain(ds.iter()))
    assert len(l1) == 4 and l1 == l2
    for a, b in zip(s1["module"].parameters(), s2["module"].parameters()):
        assert torch.equal(a, b)
    seen = []
    pf = ds.to_device_iterator(put=seen.append, depth=2)
    assert len(list(pf)) == 4 and len(seen) == 4
    pf.close()
    pf.close()


# -- codecs ------------------------------------------------------------------

def _png_with_filters(img: np.ndarray, color: int) -> bytes:
    """PNG of ``img`` (HWC BGR uint8) in color type 0/2/6 whose rows cycle
    through filters 0-4 (None, Sub, Up, Average, Paeth)."""
    rgb = img[:, :, ::-1]
    if color == 0:
        px = rgb[:, :, :1]
    elif color == 6:
        px = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 200,
                                          np.uint8)], axis=2)
    else:
        px = rgb
    h, w, nch = px.shape
    rows = px.reshape(h, w * nch).astype(np.int32)
    out, prev = [], np.zeros(w * nch, np.int32)
    for y in range(h):
        f, cur = y % 5, rows[y]
        left = np.concatenate([np.zeros(nch, np.int32), cur[:-nch]])
        upleft = np.concatenate([np.zeros(nch, np.int32), prev[:-nch]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            enc = cur - pred
        out.append(bytes([f]) + (enc % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(ctype, payload):
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("color", [0, 2, 6])
def test_png_decode_equals_the_jax_package_for_every_filter(color):
    img = _images(1, hw=9, seed=color)[0]
    data = _png_with_filters(img, color)
    want = jcodecs.decode_png(data)
    got = tcodecs.decode_png(data)
    np.testing.assert_array_equal(got, want)
    expect = np.repeat(img[:, :, 2:3], 3, axis=2) if color == 0 else img
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(tcodecs.decode_image(data), want)


def test_bmp_and_png_encode_decode_equal_the_jax_package():
    img = _images(1, hw=7, seed=4)[0]
    for enc in ("encode_bmp", "encode_png"):
        data = getattr(tcodecs, enc)(img)
        assert data == getattr(jcodecs, enc)(img)
        np.testing.assert_array_equal(tcodecs.decode_image(data), img)
    bmp32 = bytearray(jcodecs.encode_bmp(img))
    for bad in (b"", b"BM", b"\xff\xd8\xff" + b"\x00" * 10, b"GIF89a-----",
                bytes(bmp32[:30])):
        assert tcodecs.decode_image(bad) is None
        assert jcodecs.decode_image(bad) is None


def test_native_codec_equals_the_python_decoders():
    """Where the native library builds (g++, libjpeg, libpng): its PNG
    decode equals the Python decoder, and a JPEG it encodes decodes the
    same in both packages."""
    if not native_loader.native_available():
        pytest.skip(f"native codec unavailable: {native_loader.load_error()}")
    img = _images(1, hw=16, seed=8)[0]
    for color in (0, 2, 6):
        data = _png_with_filters(img, color)
        np.testing.assert_array_equal(native_loader.native_decode_png(data),
                                      tcodecs.decode_png(data))
    jpeg = native_loader.native_encode_jpeg(img, quality=90)
    assert jpeg[:3] == b"\xff\xd8\xff"
    got = tcodecs.decode_image(jpeg)
    assert got.shape == img.shape
    np.testing.assert_array_equal(got, jcodecs.decode_image(jpeg))
    batch = native_loader.native_decode_batch(
        [jpeg, b"junk", jcodecs.encode_png(img)], n_threads=2)
    np.testing.assert_array_equal(batch[0], got)
    assert batch[1] is None
    np.testing.assert_array_equal(batch[2], img)


# -- readers -----------------------------------------------------------------

@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_read_binary_files_and_read_images_equal_the_jax_package(corpus,
                                                                 ratio):
    kw = dict(recursive=True, sample_ratio=ratio, seed=4, num_partitions=3)
    tb, jb = (r.read_binary_files(corpus, **kw) for r in (treaders,
                                                          jreaders))
    assert list(tb.column("path")) == list(jb.column("path"))
    assert list(tb.column("bytes")) == list(jb.column("bytes"))
    assert tb.num_partitions == jb.num_partitions
    assert any("more.zip/inner/" in p for p in tb.column("path")) \
        or ratio < 1.0
    ti, ji = (r.read_images(corpus, decode_threads=2, **kw)
              for r in (treaders, jreaders))
    assert list(ti.column("path")) == list(ji.column("path"))
    for a, b in zip(ti.column("image"), ji.column("image")):
        assert a.path == b.path
        np.testing.assert_array_equal(a.data, b.data)
    assert ti.schema["image"].metadata == ji.schema["image"].metadata
    if ratio == 1.0:
        assert ti.schema["image"].metadata["dropped_undecodable"] == 1
        assert ti.count() == 26


def test_stream_readers_equal_the_jax_package(corpus):
    def flat(chunks, col):
        return [v for c in chunks for v in c[col]]
    tb = list(treaders.stream_binary_files(corpus, chunk_rows=5))
    jb = list(jreaders.stream_binary_files(corpus, chunk_rows=5))
    assert [len(c["path"]) for c in tb] == [len(c["path"]) for c in jb]
    assert flat(tb, "bytes") == flat(jb, "bytes")
    ti = list(treaders.stream_images(corpus, chunk_rows=5, decode_threads=2))
    ji = list(jreaders.stream_images(corpus, chunk_rows=5, decode_threads=2))
    assert flat(ti, "path") == flat(ji, "path")
    for a, b in zip(flat(ti, "image"), flat(ji, "image")):
        np.testing.assert_array_equal(a.data, b.data)
    assert treaders.list_binary_entries(corpus, process_shard=True) == \
        jreaders.list_binary_entries(corpus)


def test_truncate_and_delay_faults_act_as_in_the_jax_package(corpus):
    """``truncate`` cuts the 3rd payload of ``readers.read`` to a third in
    both packages; ``delay`` calls the plan's sleep; a truncate at a site
    without a payload raises."""
    out = {}
    for pkg in ("jax", "port"):
        faults, readers = PACKAGES[pkg][3], PACKAGES[pkg][2]
        slept = []
        spec = faults.FaultSpec("readers.read", on_hit=3, action="truncate",
                                fraction=1 / 3)
        delay = faults.FaultSpec("readers.read", on_hit=5, action="delay",
                                 delay=2.5)
        with faults.FaultPlan(spec, delay, sleep=slept.append) as plan:
            out[pkg] = list(readers.read_binary_files(corpus).column("bytes"))
        assert slept == [2.5]
        assert plan.triggered == [("readers.read", 3, "truncate"),
                                  ("readers.read", 5, "delay")]
        with faults.FaultPlan(faults.FaultSpec("data.list",
                                               action="truncate")):
            with pytest.raises(faults.InjectedFault, match="payload-less"):
                faults.fault_site("data.list")
    assert out["port"] == out["jax"]
    full = list(treaders.read_binary_files(corpus).column("bytes"))
    assert out["port"][2] == full[2][:len(full[2]) // 3]
    assert out["port"][3] == full[3]


def test_image_transformer_decodes_binary_like_the_jax_package(corpus):
    """A BINARY column through resize + flip: equal to the reference's."""
    paths = sorted(p for p in os.listdir(corpus) if p[0].isdigit())
    blobs = [open(os.path.join(corpus, p), "rb").read() for p in paths]
    col = np.empty(len(blobs), dtype=object)
    col[:] = blobs
    tframe = Frame.from_dict({"i": np.arange(len(blobs))}).with_column_values(
        ColumnSchema("raw", DType.BINARY), col)
    from mmlspark_tpu.core.schema import ColumnSchema as JColumnSchema
    from mmlspark_tpu.core.schema import DType as JDType
    jframe = JFrame.from_dict({"i": np.arange(len(blobs))}
                              ).with_column_values(
        JColumnSchema("raw", JDType.BINARY), col)
    got = ImageTransformer(inputCol="raw", outputCol="img").resize(
        4, 5).flip(1).transform(tframe).column("img")
    want = JImageTransformer(inputCol="raw", outputCol="img").resize(
        4, 5).flip(1).transform(jframe).column("img")
    assert len(got) == len(want) == 20
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.data, b.data)
        assert a.data.shape == (4, 5, 3)
