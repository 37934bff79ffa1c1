// libflairio — native fast paths for the flairtpu raster codec.
//
// Implements the hot byte-level loops the Python TIFF engine dispatches to:
// TIFF-flavour LZW decode/encode (9..12-bit MSB-first codes, ClearCode=256,
// EOI=257, early-change width rule) and the horizontal predictor. Deflate is
// handled by zlib from Python directly. All entry points are plain C ABI for
// ctypes; each returns -1 on error, and none touch global state (thread-safe).
//
// Build: flairtpu_torch/native/build.py  (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>

namespace {

constexpr int kClearCode = 256;
constexpr int kEoiCode = 257;
constexpr int kFirstCode = 258;
constexpr int kMaxTable = 4096;

struct DecodeTable {
  // Chained-prefix representation: entry = (prefix entry, final byte, length).
  int32_t prefix[kMaxTable];
  uint8_t final_byte[kMaxTable];
  int32_t length[kMaxTable];
  int32_t size;

  void reset() {
    for (int i = 0; i < 256; ++i) {
      prefix[i] = -1;
      final_byte[i] = static_cast<uint8_t>(i);
      length[i] = 1;
    }
    size = kFirstCode;
  }

  // Writes entry `code` into out (which must have `length[code]` bytes).
  void emit(int code, uint8_t* out) const {
    int n = length[code];
    for (int i = n - 1; i >= 0; --i) {
      out[i] = final_byte[code];
      code = prefix[code];
    }
  }
};

}  // namespace

extern "C" {

// Returns bytes written to dst, or -1 on malformed input / overflow.
long long flairio_lzw_decode(const char* src, long long srclen, char* dst,
                             long long dstcap) {
  const uint8_t* in = reinterpret_cast<const uint8_t*>(src);
  uint8_t* out = reinterpret_cast<uint8_t*>(dst);
  long long written = 0;

  static thread_local DecodeTable table;
  table.reset();

  long long bitpos = 0;
  const long long maxbit = srclen * 8;
  int nbits = 9;
  int prev = -1;

  while (true) {
    if (bitpos + nbits > maxbit) break;
    long long byte0 = bitpos >> 3;
    uint32_t window = static_cast<uint32_t>(in[byte0]) << 16;
    if (byte0 + 1 < srclen) window |= static_cast<uint32_t>(in[byte0 + 1]) << 8;
    if (byte0 + 2 < srclen) window |= static_cast<uint32_t>(in[byte0 + 2]);
    int shift = 24 - static_cast<int>(bitpos & 7) - nbits;
    int code = (window >> shift) & ((1 << nbits) - 1);
    bitpos += nbits;

    if (code == kEoiCode) break;
    if (code == kClearCode) {
      table.reset();
      nbits = 9;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code >= 256) return -1;
      if (written + 1 > dstcap) return -1;
      out[written++] = static_cast<uint8_t>(code);
      prev = code;
    } else {
      int entry_len;
      uint8_t first;
      if (code < table.size) {
        entry_len = table.length[code];
        if (written + entry_len > dstcap) break;
        table.emit(code, out + written);
        first = out[written];
      } else if (code == table.size) {
        // KwKwK case: prev string + its first byte.
        entry_len = table.length[prev] + 1;
        if (written + entry_len > dstcap) break;
        table.emit(prev, out + written);
        out[written + entry_len - 1] = out[written];
        first = out[written];
      } else {
        return -1;  // corrupt stream
      }
      if (table.size < kMaxTable) {
        table.prefix[table.size] = prev;
        table.final_byte[table.size] = first;
        table.length[table.size] = table.length[prev] + 1;
        table.size++;
      }
      written += entry_len;
      prev = code;
    }
    // Early change: widen when the table holds (1<<nbits)-1 entries.
    if (table.size + 1 >= (1 << nbits) && nbits < 12) nbits++;
    if (written >= dstcap) break;
  }
  return written;
}

// Hash-table LZW encoder. Returns bytes written, or -1 on overflow.
long long flairio_lzw_encode(const char* src, long long srclen, char* dst,
                             long long dstcap) {
  const uint8_t* in = reinterpret_cast<const uint8_t*>(src);
  uint8_t* out = reinterpret_cast<uint8_t*>(dst);
  long long written = 0;

  // Open-addressing map from (prefix_code << 8 | byte) -> code.
  constexpr int kHashBits = 14;
  constexpr int kHashSize = 1 << kHashBits;
  static thread_local int32_t hash_key[kHashSize];
  static thread_local int16_t hash_val[kHashSize];

  uint32_t bitbuf = 0;
  int bitcount = 0;
  int nbits = 9;
  int next_code = kFirstCode;

  auto put = [&](int code) -> bool {
    bitbuf = (bitbuf << nbits) | static_cast<uint32_t>(code);
    bitcount += nbits;
    while (bitcount >= 8) {
      bitcount -= 8;
      if (written >= dstcap) return false;
      out[written++] = static_cast<uint8_t>((bitbuf >> bitcount) & 0xFF);
    }
    return true;
  };

  auto clear_hash = [&]() { memset(hash_key, 0xFF, sizeof(hash_key)); };

  clear_hash();
  if (!put(kClearCode)) return -1;
  if (srclen == 0) {
    if (!put(kEoiCode)) return -1;
    if (bitcount) {
      if (written >= dstcap) return -1;
      out[written++] = static_cast<uint8_t>((bitbuf << (8 - bitcount)) & 0xFF);
    }
    return written;
  }

  int w = in[0];
  for (long long i = 1; i < srclen; ++i) {
    const uint8_t c = in[i];
    const int32_t key = (w << 8) | c;
    uint32_t h = (static_cast<uint32_t>(key) * 2654435761u) >> (32 - kHashBits);
    int code = -1;
    while (hash_key[h] != -1) {
      if (hash_key[h] == key) {
        code = hash_val[h];
        break;
      }
      h = (h + 1) & (kHashSize - 1);
    }
    if (code >= 0) {
      w = code;
      continue;
    }
    if (!put(w)) return -1;
    hash_key[h] = key;
    hash_val[h] = static_cast<int16_t>(next_code);
    next_code++;
    if (next_code == (1 << nbits) && nbits < 12) {
      nbits++;
    } else if (next_code == 4094) {
      if (!put(kClearCode)) return -1;
      clear_hash();
      next_code = kFirstCode;
      nbits = 9;
    }
    w = c;
  }
  if (!put(w)) return -1;
  if (!put(kEoiCode)) return -1;
  if (bitcount) {
    if (written >= dstcap) return -1;
    out[written++] = static_cast<uint8_t>((bitbuf << (8 - bitcount)) & 0xFF);
  }
  return written;
}

// In-place horizontal predictor decode (TIFF Predictor=2) for uint8 buffers
// shaped (rows, cols, samples): cumulative sum along cols per sample.
void flairio_predictor2_u8(void* data, long long rows, long long cols,
                           long long samples) {
  uint8_t* p = static_cast<uint8_t*>(data);
  const long long rowstride = cols * samples;
  for (long long r = 0; r < rows; ++r) {
    uint8_t* row = p + r * rowstride;
    for (long long i = samples; i < rowstride; ++i) {
      row[i] = static_cast<uint8_t>(row[i] + row[i - samples]);
    }
  }
}

}  // extern "C"
