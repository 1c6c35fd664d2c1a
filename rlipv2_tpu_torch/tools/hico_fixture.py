"""The JPEG fixture of the HICO loader: smooth seeded images at HICO-DET's
sizes, encoded as tests/fixtures/hico_jpeg/*.jpg.

`source_image(spec)` rebuilds each file's source from its seed with numpy
alone, so a test (against PIL's decode) and `chip_smoke.py` (against
nvJPEG's) can hold a decode to its source by PSNR. The files were written by

    python -m rlipv2_tpu_torch.tools.hico_fixture

which needs PIL (the JPEG encoder) and is not run by anything else.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "hico_jpeg"
QUALITY = 95
MIN_PSNR_DB = 35.0


class FixtureSpec(NamedTuple):
    name: str
    height: int
    width: int
    subsampling: str  # "4:2:0" | "4:4:4" | "gray"
    seed: int


# width x height as HICO-DET's images come: 640x480 and 640x427 landscapes,
# 480x640 and 427x640 portraits, and an odd size for the chroma edge
FIXTURES = (
    FixtureSpec("hico_0_640x480_420.jpg", 480, 640, "4:2:0", 0),
    FixtureSpec("hico_1_480x640_420.jpg", 640, 480, "4:2:0", 1),
    FixtureSpec("hico_2_427x640_444.jpg", 640, 427, "4:4:4", 2),
    FixtureSpec("hico_3_640x427_444.jpg", 427, 640, "4:4:4", 3),
    FixtureSpec("hico_4_640x480_gray.jpg", 480, 640, "gray", 4),
    FixtureSpec("hico_5_500x333_420.jpg", 333, 500, "4:2:0", 5),
)
# a 4-component (CMYK) file, which the loader refuses
CMYK_FIXTURE = "cmyk_32x24.jpg"


def source_image(spec: FixtureSpec) -> np.ndarray:
    """(H, W, 3) uint8 RGB: per channel a mean plus eight low-frequency
    plane waves drawn from the spec's seed; gray repeats one channel."""
    rng = np.random.RandomState(spec.seed)
    y, x = np.mgrid[: spec.height, : spec.width].astype(np.float64)
    channels = 1 if spec.subsampling == "gray" else 3
    out = np.empty((spec.height, spec.width, channels))
    for c in range(channels):
        img = np.full_like(y, rng.uniform(70, 180))
        for _ in range(8):
            fy, fx = rng.uniform(-1.5, 1.5, 2) / 100.0  # cycles a pixel: periods of 65 px and longer
            img += rng.uniform(5, 18) * np.sin(2 * np.pi * (fy * y + fx * x) + rng.uniform(0, 2 * np.pi))
        out[..., c] = img
    img = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return np.repeat(img, 3, axis=2) if channels == 1 else img


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def main() -> None:
    from PIL import Image

    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    for spec in FIXTURES:
        img = source_image(spec)
        if spec.subsampling == "gray":
            Image.fromarray(img[..., 0], "L").save(FIXTURE_DIR / spec.name, quality=QUALITY)
        else:
            sub = {"4:4:4": 0, "4:2:0": 2}[spec.subsampling]
            Image.fromarray(img, "RGB").save(FIXTURE_DIR / spec.name, quality=QUALITY, subsampling=sub)
        size = (FIXTURE_DIR / spec.name).stat().st_size
        print(f"{spec.name}: {size} bytes")
    cmyk = np.random.RandomState(6).randint(0, 256, (24, 32, 4)).astype(np.uint8)
    Image.fromarray(cmyk, "CMYK").save(FIXTURE_DIR / CMYK_FIXTURE, quality=QUALITY)


if __name__ == "__main__":
    main()
