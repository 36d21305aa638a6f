// crlot-tpu native runtime: host-side data-loader components in C++17.
//
// The reference implements its I/O and streaming layers natively (io/wav.cc
// over dr_wav; dsp/frame/framer.cc; dsp/ring/ring_buffer.cc). This library is
// the TPU build's equivalent host runtime: a WAV codec, a wrap-free ring
// buffer, and a streaming framer that emits device-ready [frames, channels,
// frame_size] batches. Exposed as a C ABI for ctypes.
//
// Contract parity (independent implementation, no code taken from the
// reference):
//  - WAV: PCM 16/24/32-bit + IEEE float32; decode to f32 in [-1,1] with
//    symmetric scale 2^(bits-1)-1; encode clamps, rounds-to-nearest, packs
//    24-bit as 3-byte LE (semantics of io/wav.cc:207-259).
//  - Framer: available = floor((N - frame)/hop) + 1; ZERO_PAD yields one
//    zero-filled partial after flush; DROP refuses partials; read cursor
//    advances by hop; geometric growth + compaction (framer.cc:88-179).
//  - RingBuffer: capacity > 0; split(start, len) -> up to two spans with
//    clamping; optional 2x shadow mirror for wrap-free reads
//    (ring_buffer.cc:14-163).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#define CRLOT_API extern "C" __attribute__((visibility("default")))

namespace {

constexpr uint16_t kFmtPcm = 1;
constexpr uint16_t kFmtFloat = 3;
constexpr uint16_t kFmtExtensible = 0xFFFE;

struct WavInfo {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t rate = 0;
  uint16_t bits = 0;
  uint16_t block_align = 0;
  const uint8_t* data = nullptr;
  uint64_t data_len = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

// Returns 0 on success, negative error code otherwise.
int parse_wav(const uint8_t* blob, uint64_t len, WavInfo* out) {
  if (len < 12 || std::memcmp(blob, "RIFF", 4) != 0 ||
      std::memcmp(blob + 8, "WAVE", 4) != 0)
    return -1;  // not RIFF/WAVE
  uint64_t pos = 12;
  bool have_fmt = false;
  while (pos + 8 <= len) {
    const uint8_t* cid = blob + pos;
    uint32_t size = rd_u32(blob + pos + 4);
    uint64_t body = pos + 8;
    if (body + size > len) size = static_cast<uint32_t>(len - body);
    if (std::memcmp(cid, "fmt ", 4) == 0 && size >= 16) {
      out->format = rd_u16(blob + body);
      out->channels = rd_u16(blob + body + 2);
      out->rate = rd_u32(blob + body + 4);
      out->block_align = rd_u16(blob + body + 12);
      out->bits = rd_u16(blob + body + 14);
      if (out->format == kFmtExtensible && size >= 26)
        out->format = rd_u16(blob + body + 24);
      have_fmt = true;
    } else if (std::memcmp(cid, "data", 4) == 0) {
      out->data = blob + body;
      out->data_len = size;
    }
    pos = body + size + (size & 1);  // word alignment
  }
  if (!have_fmt || out->data == nullptr) return -2;   // missing chunk
  if (out->format != kFmtPcm && out->format != kFmtFloat) return -3;
  if (out->bits != 16 && out->bits != 24 && out->bits != 32) return -4;
  if (out->format == kFmtFloat && out->bits != 32) return -4;
  if (out->channels < 1) return -5;
  if (out->block_align == 0) return -6;
  return 0;
}

inline float full_scale(int bits) {
  return static_cast<float>((1u << (bits - 1)) - 1);
}

}  // namespace

// ---------------------------------------------------------------- WAV codec

CRLOT_API int crlot_wav_info(const uint8_t* blob, uint64_t len, int32_t* channels,
                             int32_t* rate, int32_t* bits, int32_t* is_float,
                             int64_t* frames) {
  WavInfo info;
  int rc = parse_wav(blob, len, &info);
  if (rc != 0) return rc;
  *channels = info.channels;
  *rate = static_cast<int32_t>(info.rate);
  *bits = info.bits;
  *is_float = info.format == kFmtFloat ? 1 : 0;
  *frames = static_cast<int64_t>(info.data_len / info.block_align);
  return 0;
}

// out must hold frames*channels floats (interleaved).
CRLOT_API int crlot_wav_decode(const uint8_t* blob, uint64_t len, float* out) {
  WavInfo info;
  int rc = parse_wav(blob, len, &info);
  if (rc != 0) return rc;
  const uint64_t n = (info.data_len / info.block_align) * info.channels;
  const uint8_t* p = info.data;
  if (info.format == kFmtFloat) {
    std::memcpy(out, p, n * 4);
    return 0;
  }
  // Decode divides by full scale (not multiply-by-reciprocal) so results
  // are bit-identical to the numpy reference path.
  if (info.bits == 16) {
    const float s = full_scale(16);
    for (uint64_t i = 0; i < n; ++i) {
      int16_t v;
      std::memcpy(&v, p + 2 * i, 2);
      out[i] = static_cast<float>(v) / s;
    }
  } else if (info.bits == 24) {
    const float s = full_scale(24);
    for (uint64_t i = 0; i < n; ++i) {
      const uint8_t* q = p + 3 * i;
      int32_t v = q[0] | (q[1] << 8) | (q[2] << 16);
      if (v & 0x800000) v -= (1 << 24);
      out[i] = static_cast<float>(v) / s;
    }
  } else {  // 32-bit PCM
    const float s = full_scale(32);
    for (uint64_t i = 0; i < n; ++i) {
      int32_t v;
      std::memcpy(&v, p + 4 * i, 4);
      out[i] = static_cast<float>(v) / s;
    }
  }
  return 0;
}

CRLOT_API int64_t crlot_wav_encoded_size(int64_t frames, int32_t channels,
                                         int32_t bits) {
  const int64_t payload = frames * channels * (bits / 8);
  return 12 + 8 + 16 + 8 + payload + (payload & 1);
}

// data: interleaved f32 [frames*channels]; out sized by crlot_wav_encoded_size.
CRLOT_API int crlot_wav_encode(const float* data, int64_t frames,
                               int32_t channels, int32_t rate, int32_t bits,
                               int32_t is_float, uint8_t* out,
                               int64_t* out_len) {
  if (channels < 1 || rate <= 0) return -5;
  if (is_float) bits = 32;
  if (bits != 16 && bits != 24 && bits != 32) return -4;
  const int64_t n = frames * channels;
  const int64_t payload = n * (bits / 8);
  const uint16_t block_align = static_cast<uint16_t>(channels * bits / 8);
  uint8_t* p = out;
  auto w32 = [&p](uint32_t v) { std::memcpy(p, &v, 4); p += 4; };
  auto w16 = [&p](uint16_t v) { std::memcpy(p, &v, 2); p += 2; };
  const int64_t riff_len = 4 + 8 + 16 + 8 + payload + (payload & 1);
  std::memcpy(p, "RIFF", 4); p += 4;
  w32(static_cast<uint32_t>(riff_len));
  std::memcpy(p, "WAVE", 4); p += 4;
  std::memcpy(p, "fmt ", 4); p += 4;
  w32(16);
  w16(is_float ? kFmtFloat : kFmtPcm);
  w16(static_cast<uint16_t>(channels));
  w32(static_cast<uint32_t>(rate));
  w32(static_cast<uint32_t>(rate * block_align));
  w16(block_align);
  w16(static_cast<uint16_t>(bits));
  std::memcpy(p, "data", 4); p += 4;
  w32(static_cast<uint32_t>(payload));
  if (is_float) {
    std::memcpy(p, data, payload);
    p += payload;
  } else {
    const float scale = full_scale(bits);
    if (bits == 16) {
      for (int64_t i = 0; i < n; ++i) {
        float c = std::min(1.0f, std::max(-1.0f, data[i]));
        int16_t v = static_cast<int16_t>(std::lrintf(c * scale));
        std::memcpy(p, &v, 2); p += 2;
      }
    } else if (bits == 24) {
      for (int64_t i = 0; i < n; ++i) {
        float c = std::min(1.0f, std::max(-1.0f, data[i]));
        int32_t v = static_cast<int32_t>(std::lrintf(c * scale));
        p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF; p[2] = (v >> 16) & 0xFF;
        p += 3;
      }
    } else {
      for (int64_t i = 0; i < n; ++i) {
        float c = std::min(1.0f, std::max(-1.0f, data[i]));
        int32_t v = static_cast<int32_t>(std::lrint(static_cast<double>(c) * scale));
        std::memcpy(p, &v, 4); p += 4;
      }
    }
  }
  if (payload & 1) *p++ = 0;
  *out_len = p - out;
  return 0;
}

// --------------------------------------------------------------- RingBuffer
//
// Dtype-generic: the reference instantiates RingBuffer<T> for float/double/
// int16/int32/uint16/uint32 (ring_buffer.cc:207-213). The split arithmetic is
// type-free; write/read/shadow-sync only need the element size, so the ring
// stores raw bytes plus an elem_size and the C ABI stays a single set of
// void* entry points (crlot_ring_create_typed picks the width).

struct CrlotRing {
  std::vector<uint8_t> buf;  // capacity*elem (or 2x in shadow mode)
  int64_t capacity = 0;      // in elements
  int64_t elem = 4;          // element size in bytes
  bool shadow = false;
};

CRLOT_API void* crlot_ring_create_typed(int64_t capacity, int32_t shadow,
                                        int64_t elem_size) {
  if (capacity <= 0) return nullptr;
  if (elem_size != 1 && elem_size != 2 && elem_size != 4 && elem_size != 8)
    return nullptr;
  auto* r = new CrlotRing();
  r->capacity = capacity;
  r->elem = elem_size;
  r->shadow = shadow != 0;
  r->buf.assign((shadow ? 2 * capacity : capacity) * elem_size, 0);
  return r;
}

// f32 ring (the pipeline's type); kept as the short-hand entry point.
CRLOT_API void* crlot_ring_create(int64_t capacity, int32_t shadow) {
  return crlot_ring_create_typed(capacity, shadow, 4);
}

CRLOT_API int64_t crlot_ring_elem_size(void* h) {
  return static_cast<CrlotRing*>(h)->elem;
}

CRLOT_API void crlot_ring_destroy(void* h) { delete static_cast<CrlotRing*>(h); }

// split(start, len): writes span offsets/lengths; returns span count (1 or 2).
CRLOT_API int crlot_ring_split(void* h, int64_t start, int64_t len,
                               int64_t* off0, int64_t* len0, int64_t* off1,
                               int64_t* len1) {
  auto* r = static_cast<CrlotRing*>(h);
  len = std::min(len, r->capacity);
  start %= r->capacity;
  if (start < 0) start += r->capacity;
  const int64_t first = std::min(len, r->capacity - start);
  *off0 = start;
  *len0 = first;
  if (first == len) { *off1 = 0; *len1 = 0; return 1; }
  *off1 = 0;
  *len1 = len - first;
  return 2;
}

// write n elements at start (wrapping); keeps the shadow mirror in sync.
CRLOT_API void crlot_ring_write(void* h, int64_t start, const void* src,
                                int64_t n) {
  auto* r = static_cast<CrlotRing*>(h);
  const int64_t e = r->elem;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  int64_t o0, l0, o1, l1;
  crlot_ring_split(h, start, n, &o0, &l0, &o1, &l1);
  std::memcpy(r->buf.data() + o0 * e, s, l0 * e);
  if (l1 > 0) std::memcpy(r->buf.data() + o1 * e, s + l0 * e, l1 * e);
  if (r->shadow) {
    // Mirror [0, capacity) into [capacity, 2*capacity).
    std::memcpy(r->buf.data() + (r->capacity + o0) * e, s, l0 * e);
    if (l1 > 0)
      std::memcpy(r->buf.data() + (r->capacity + o1) * e, s + l0 * e, l1 * e);
  }
}

// contiguous read of n elements from start (uses the shadow to avoid copies
// when possible; always emits a contiguous result into out).
CRLOT_API void crlot_ring_read(void* h, int64_t start, void* out, int64_t n) {
  auto* r = static_cast<CrlotRing*>(h);
  const int64_t e = r->elem;
  uint8_t* d = static_cast<uint8_t*>(out);
  int64_t o0, l0, o1, l1;
  crlot_ring_split(h, start, n, &o0, &l0, &o1, &l1);
  std::memcpy(d, r->buf.data() + o0 * e, l0 * e);
  if (l1 > 0) std::memcpy(d + l0 * e, r->buf.data() + o1 * e, l1 * e);
}

CRLOT_API int64_t crlot_ring_capacity(void* h) {
  return static_cast<CrlotRing*>(h)->capacity;
}

// ------------------------------------------------------------------- Framer

struct CrlotFramer {
  int64_t frame = 0, hop = 0, channels = 0;
  bool zero_pad = true;
  bool flushed = false;
  std::vector<float> buf;  // interleaved
  int64_t read = 0, write = 0;  // in frames-per-channel units
};

CRLOT_API void* crlot_framer_create(int64_t frame, int64_t hop,
                                    int64_t channels, int32_t zero_pad) {
  if (frame <= 0 || hop <= 0 || channels <= 0) return nullptr;
  auto* f = new CrlotFramer();
  f->frame = frame;
  f->hop = hop;
  f->channels = channels;
  f->zero_pad = zero_pad != 0;
  f->buf.assign(static_cast<size_t>(frame * channels * 4), 0.0f);
  return f;
}

CRLOT_API void crlot_framer_destroy(void* h) {
  delete static_cast<CrlotFramer*>(h);
}

CRLOT_API int crlot_framer_push(void* h, const float* interleaved,
                                int64_t samples_per_ch) {
  auto* f = static_cast<CrlotFramer*>(h);
  if (f->flushed) return -1;
  const int64_t need = (f->write + samples_per_ch) * f->channels;
  if (static_cast<int64_t>(f->buf.size()) < need) {
    size_t ns = f->buf.size();
    while (static_cast<int64_t>(ns) < need) ns *= 2;
    f->buf.resize(ns, 0.0f);
  }
  std::memcpy(f->buf.data() + f->write * f->channels, interleaved,
              samples_per_ch * f->channels * sizeof(float));
  f->write += samples_per_ch;
  return 0;
}

CRLOT_API void crlot_framer_flush(void* h) {
  static_cast<CrlotFramer*>(h)->flushed = true;
}

CRLOT_API int64_t crlot_framer_available(void* h) {
  auto* f = static_cast<CrlotFramer*>(h);
  const int64_t n = f->write - f->read;
  int64_t full = n >= f->frame ? (n - f->frame) / f->hop + 1 : 0;
  if (f->flushed && f->zero_pad && n - full * f->hop > 0) full += 1;
  return std::max<int64_t>(full, 0);
}

// Pops up to max_frames into out as [frames, channels, frame] (deinterleaved
// SoA planes per frame — device batch layout). Returns frames written.
CRLOT_API int64_t crlot_framer_pop_batch(void* h, float* out,
                                         int64_t max_frames) {
  auto* f = static_cast<CrlotFramer*>(h);
  int64_t count = std::min(crlot_framer_available(h), max_frames);
  for (int64_t k = 0; k < count; ++k) {
    const int64_t have = std::min(f->write - f->read, f->frame);
    const float* src = f->buf.data() + f->read * f->channels;
    float* dst = out + k * f->channels * f->frame;
    std::memset(dst, 0, f->channels * f->frame * sizeof(float));
    for (int64_t i = 0; i < have; ++i)
      for (int64_t c = 0; c < f->channels; ++c)
        dst[c * f->frame + i] = src[i * f->channels + c];
    if (have < f->frame) {
      f->read = f->write;  // flushed partial consumes the tail
    } else {
      f->read += f->hop;
    }
  }
  // Compaction once read passes half the buffer (framer.cc:169-179 analog).
  if (f->read * f->channels * 2 >= static_cast<int64_t>(f->buf.size())) {
    const int64_t n = (f->write - f->read) * f->channels;
    std::memmove(f->buf.data(), f->buf.data() + f->read * f->channels,
                 n * sizeof(float));
    f->write -= f->read;
    f->read = 0;
  }
  return count;
}

CRLOT_API void crlot_framer_reset(void* h) {
  auto* f = static_cast<CrlotFramer*>(h);
  f->read = f->write = 0;
  f->flushed = false;
  std::fill(f->buf.begin(), f->buf.end(), 0.0f);
}

CRLOT_API int32_t crlot_native_abi_version() { return 2; }
