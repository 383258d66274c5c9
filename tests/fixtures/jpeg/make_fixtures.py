"""Write the baseline JPEG fixtures of this directory and their reference
decodes.

Eight images over four classes (``<class>_<i>.jpg``), 180–500 px wide,
made from seed 0 with numpy (smooth gradients, discs and bars, light
noise) and encoded with PIL at quality 90: 4:2:0 chroma (PIL's default),
4:4:4 for ``b_0`` and ``d_1``, and ``c_1`` in grayscale. ``decoded.npz``
holds each file's decode by the JAX package's native baseline decoder
(``utils/native.py::jpeg_decode``), the reference the port's decoder is
held to bitwise where PIL is absent (the card's machine).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/fixtures/jpeg/make_fixtures.py
"""

import io
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
#: name → (height, width, subsampling, grayscale)
SPECS = {
    "a_0": (240, 320, 2, False), "a_1": (150, 180, 2, False),
    "b_0": (200, 260, 0, False), "b_1": (375, 500, 2, False),
    "c_0": (256, 256, 2, False), "c_1": (210, 280, 2, True),
    "d_0": (300, 224, 2, False), "d_1": (190, 330, 0, False),
}


def image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = rng.uniform(40, 200, 3)
    slope = rng.uniform(-0.4, 0.4, (2, 3))
    img = base + y[..., None] * slope[0] + x[..., None] * slope[1]
    for _ in range(4):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(15, 60)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    x0 = int(rng.integers(0, w - 20))
    img[:, x0:x0 + 12] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 1.5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> None:
    from distributeddeeplearningspark_tpu.utils import native

    rng = np.random.default_rng(0)
    decoded = {}
    for name, (h, w, sub, gray) in SPECS.items():
        pil = Image.fromarray(image(rng, h, w))
        if gray:
            pil = pil.convert("L")
        buf = io.BytesIO()
        pil.save(buf, format="JPEG", quality=90, subsampling=sub)
        (HERE / f"{name}.jpg").write_bytes(buf.getvalue())
        decoded[name] = native.jpeg_decode(buf.getvalue())
    np.savez_compressed(HERE / "decoded.npz", **decoded)


if __name__ == "__main__":
    main()
