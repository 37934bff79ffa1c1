"""First-party raster I/O: GeoTIFF/BigTIFF reader+writer with windowed access.

The reference delegates all raster I/O to GDAL via rasterio (e.g. reference
src/flair/data_loader.py:60-69, src/zone_detect/dataset.py:92-104,
src/zone_detect/main.py:206-232). This framework ships its own codec:

- :mod:`flairtpu_torch.io.tiff` — TIFF/BigTIFF parsing, tiled+striped layouts,
  windowed boundless reads with bilinear resampling, tiled BigTIFF writing
  with LZW/deflate compression and GeoTIFF georeferencing tags.
- :mod:`flairtpu_torch.io.codecs` — compression codecs (LZW, deflate, PackBits,
  horizontal predictor) with a native C++ fast path (libflairio) and pure
  NumPy/Python fallbacks.
"""

from flairtpu_torch.io.tiff import TiffReader, TiffWriter, Window  # noqa: F401
