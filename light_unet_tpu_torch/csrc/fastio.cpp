// fastio -- native NIfTI-1 host I/O of the PyTorch port, bound with ctypes by
// light_unet_tpu_torch/utils/fastio.py.
//
// Port of native/fastio.cpp (the JAX package's library) with the same C
// entries and the same results bit for bit: gzip inflate + dtype conversion
// + scl_slope/inter scaling outside the Python GIL, a thread pool for a
// batch of files, exact order statistics for the clip percentiles, and the
// single-pass uint16 quantize + pad of the serving upload.  The order
// statistics are a radix select, not the JAX library's nth_element: the same
// values, a zero returned as +0.0.
//
// The inflate is this file's own (RFC 1951 / RFC 1952), because a GPU host
// may have a C++ compiler but neither zlib's nor libdeflate's headers.  It
// is table-driven in libdeflate's manner, since Python's own zlib is the
// plain version it has to beat:
//   - a 64-bit bit buffer refilled by whole 8-byte words (byte by byte, with
//     zero bytes counted past the end, only near the end of the input);
//   - an 11-bit primary literal/length table and an 8-bit distance table,
//     with sub-tables for longer codes; one entry carries the code length,
//     the symbol's base value and its count of extra bits, so a length or
//     distance costs one lookup and one shift;
//   - a fast loop, while 8 input bytes and a whole match fit, that decodes
//     up to three literals per refill and looks the next entry up before the
//     refill it does not depend on;
//   - match copies by 8-byte words when the distance is 8 or more, a memset
//     for distance 1;
//   - every input read and output write bounds-checked (the fast loop by its
//     entry condition): headers and streams come from files and are not
//     trusted;
//   - CRC-32 (slice-by-16) and ISIZE checked when the member ends inside the
//     requested output.
// Prefix semantics, as the JAX library's zlib path gives them
// (native/fastio.cpp:60, :219-222): the first member is decoded up to the
// output capacity and decoding stops there; a member that ends earlier
// yields fewer bytes (the caller reports kErrShort); bytes after the member
// are ignored.
//
// Build (ops/_build.py:build_host): c++ -O3 -std=c++17 -fPIC -shared -pthread
// -ffp-contract=off.  -ffp-contract=off keeps each float32 operation of the
// scaled decode and of quantize_pad its own rounding, as numpy rounds them.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <new>
#include <thread>
#include <vector>

namespace {

constexpr int kHeaderSize = 348;

enum ErrorCode {
  kOk = 0,
  kErrOpen = -1,
  kErrGzip = -2,    // not gzip, or corrupt deflate data / trailer
  kErrHeader = -3,
  kErrDtype = -4,
  kErrShort = -5,   // truncated file or stream
  kErrAlloc = -6,
  kErrData = -7,    // non-finite values in order-stats input
};

// ---------------------------------------------------------------- CRC-32

struct Crc32Tables {
  uint32_t t[16][256];
  Crc32Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1u)));
      t[0][i] = c;
    }
    for (int s = 1; s < 16; ++s)
      for (uint32_t i = 0; i < 256; ++i) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
  }
};

const Crc32Tables& crc_tables() {
  static const Crc32Tables tables;  // built once, thread-safe (magic static)
  return tables;
}

inline uint32_t load_le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

inline uint64_t load_le64(const uint8_t* p) {
  return uint64_t(load_le32(p)) | uint64_t(load_le32(p + 4)) << 32;
}

// CRC-32 (gzip's polynomial), slice-by-16.
uint32_t crc32(const uint8_t* p, size_t n) {
  const auto& T = crc_tables().t;
  uint32_t crc = 0xFFFFFFFFu;
  for (; n >= 16; n -= 16, p += 16) {
    const uint32_t a = load_le32(p) ^ crc, b = load_le32(p + 4), c = load_le32(p + 8),
                   d = load_le32(p + 12);
    crc = T[15][a & 0xff] ^ T[14][(a >> 8) & 0xff] ^ T[13][(a >> 16) & 0xff] ^ T[12][a >> 24] ^
          T[11][b & 0xff] ^ T[10][(b >> 8) & 0xff] ^ T[9][(b >> 16) & 0xff] ^ T[8][b >> 24] ^
          T[7][c & 0xff] ^ T[6][(c >> 8) & 0xff] ^ T[5][(c >> 16) & 0xff] ^ T[4][c >> 24] ^
          T[3][d & 0xff] ^ T[2][(d >> 8) & 0xff] ^ T[1][(d >> 16) & 0xff] ^ T[0][d >> 24];
  }
  for (; n; --n) crc = (crc >> 8) ^ T[0][(crc ^ *p++) & 0xff];
  return ~crc;
}

// ------------------------------------------------------------- Huffman

// A decode-table entry:
//   bits 0-4   bits to consume (a code's length; a sub-table pointer's root bits)
//   bits 8-11  extra bits after the code (a sub-table pointer: its index bits)
//   bits 12-15 kind (0: invalid code)
//   bits 16-31 value: literal byte, base length or distance, precode symbol,
//              or a sub-table's offset
constexpr uint32_t kLit = 1u << 12;   // literal / precode symbol
constexpr uint32_t kBase = 2u << 12;  // length or distance: value + extra bits
constexpr uint32_t kEob = 4u << 12;
constexpr uint32_t kSub = 8u << 12;

constexpr unsigned kLitlenBits = 11, kDistBits = 8, kPrecodeBits = 7;
constexpr uint32_t kLitlenMask = (1u << kLitlenBits) - 1, kDistMask = (1u << kDistBits) - 1;
// the largest tables a complete code can need at these root sizes (zlib's
// `enough` for 288 / 32 symbols and 15-bit codes); build_table checks anyway
constexpr size_t kLitlenEnough = 2342, kDistEnough = 402, kPrecodeEnough = 128;

inline uint32_t entry(uint32_t kind, uint32_t value, uint32_t extra) {
  return kind | (value << 16) | (extra << 8);
}

// Canonical Huffman decode table for lens[0..n) (each 0..15), zlib's
// construction (inflate_table): symbols sorted by length, the bit-reversed
// code advanced by a backwards increment, sub-tables sized by the codes that
// remain.  sym_entry[s] is symbol s's entry without its length.  Returns
// false for an over-subscribed code, or an incomplete one that zlib refuses
// (any incomplete precode; any other incomplete code but a single 1-bit
// code).  With no codes at all every lookup is invalid.
bool build_table(uint32_t* table, size_t cap, unsigned root, const uint8_t* lens, unsigned n,
                 const uint32_t* sym_entry, bool precode) {
  unsigned count[16] = {0};
  for (unsigned s = 0; s < n; ++s) count[lens[s]]++;
  count[0] = 0;
  unsigned max = 15;
  while (max >= 1 && count[max] == 0) --max;
  const size_t primary = size_t(1) << root;
  if (max == 0) {
    std::fill_n(table, primary, 0u);
    return true;
  }
  int left = 1;
  for (unsigned len = 1; len <= 15; ++len) {
    left = (left << 1) - int(count[len]);
    if (left < 0) return false;
  }
  if (left > 0) {
    if (precode || max != 1) return false;
    std::fill_n(table, primary, 0u);  // the unused half stays invalid
  }
  unsigned offs[16];
  offs[1] = 0;
  for (unsigned len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
  uint16_t work[320];
  for (unsigned s = 0; s < n; ++s)
    if (lens[s]) work[offs[lens[s]]++] = uint16_t(s);

  unsigned sym = 0, len = lens[work[0]];
  uint32_t huff = 0;          // the current code, bit-reversed
  uint32_t* next = table;     // the table being filled
  unsigned curr = root;       // its index bits
  unsigned drop = 0;          // bits consumed before indexing it
  uint32_t low = ~0u;         // primary index of the current sub-table
  const uint32_t mask = uint32_t(primary) - 1;
  size_t used = primary;
  for (;;) {
    const uint32_t here = sym_entry[work[sym]] | (len - drop);
    uint32_t incr = 1u << (len - drop);
    uint32_t fill = 1u << curr;
    do {
      fill -= incr;
      next[(huff >> drop) + fill] = here;
    } while (fill != 0);
    incr = 1u << (len - 1);
    while (huff & incr) incr >>= 1;
    huff = incr ? (huff & (incr - 1)) + incr : 0;
    ++sym;
    if (--count[len] == 0) {
      if (len == max) break;
      len = lens[work[sym]];
    }
    if (len > root && (huff & mask) != low) {
      if (drop == 0) drop = root;
      next += size_t(1) << curr;
      curr = len - drop;
      int room = 1 << curr;
      while (curr + drop < max) {
        room -= int(count[curr + drop]);
        if (room <= 0) break;
        ++curr;
        room <<= 1;
      }
      used += size_t(1) << curr;
      if (used > cap) return false;
      low = huff & mask;
      table[low] = entry(kSub, uint32_t(next - table), curr) | root;
    }
  }
  return true;
}

constexpr uint16_t kLengthBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                      31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr uint8_t kLengthExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                      2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                    33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                    1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
constexpr uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,  4,  4,  5,  5,  6,
                                    6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
constexpr uint8_t kPrecodeOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

struct SymbolEntries {
  uint32_t litlen[288], dist[32], precode[19];
  SymbolEntries() {
    for (uint32_t s = 0; s < 256; ++s) litlen[s] = entry(kLit, s, 0);
    litlen[256] = kEob;
    for (uint32_t s = 257; s < 286; ++s)
      litlen[s] = entry(kBase, kLengthBase[s - 257], kLengthExtra[s - 257]);
    litlen[286] = litlen[287] = 0;  // in the fixed code only, and invalid there
    for (uint32_t s = 0; s < 30; ++s) dist[s] = entry(kBase, kDistBase[s], kDistExtra[s]);
    dist[30] = dist[31] = 0;
    for (uint32_t s = 0; s < 19; ++s) precode[s] = entry(kLit, s, 0);
  }
};

const SymbolEntries& symbols() {
  static const SymbolEntries e;
  return e;
}

struct FixedTables {
  uint32_t litlen[kLitlenEnough], dist[kDistEnough];
  FixedTables() {
    uint8_t lens[288];
    std::fill_n(lens, 144, 8);
    std::fill_n(lens + 144, 112, 9);
    std::fill_n(lens + 256, 24, 7);
    std::fill_n(lens + 280, 8, 8);
    build_table(litlen, kLitlenEnough, kLitlenBits, lens, 288, symbols().litlen, false);
    std::fill_n(lens, 32, 5);
    build_table(dist, kDistEnough, kDistBits, lens, 32, symbols().dist, false);
  }
};

const FixedTables& fixed_tables() {
  static const FixedTables t;
  return t;
}

// ------------------------------------------------------------- inflate

// Longest output one fast-loop iteration may touch: a 258-byte match copied
// by 8-byte words runs up to 7 bytes past its end.
constexpr size_t kFastOutSlack = 258 + 8;

struct Inflated {
  int rc;            // kOk or a negative ErrorCode
  size_t produced;   // bytes written to the output
  bool ended;        // the final block ended (else: the output filled first)
  size_t in_used;    // when ended: input bytes up to the byte-aligned end
};

// Decode one raw deflate stream into out[0..out_cap).
Inflated inflate_raw(const uint8_t* const in_begin, size_t in_len, uint8_t* const out_begin,
                     size_t out_cap) {
  const uint8_t* in = in_begin;
  const uint8_t* const in_end = in_begin + in_len;
  uint8_t* out = out_begin;
  uint8_t* const out_end = out_begin + out_cap;
  uint64_t bitbuf = 0;   // bits above `bitsleft` repeat the next input bits or are 0
  unsigned bitsleft = 0;
  size_t overread = 0;   // zero bytes fed past the end of the input
  uint32_t litlen_dyn[kLitlenEnough], dist_dyn[kDistEnough], precode[kPrecodeEnough];
  const SymbolEntries& syms = symbols();

  auto refill_slow = [&]() {
    while (bitsleft <= 56) {
      uint64_t byte = 0;
      if (in != in_end)
        byte = *in++;
      else
        ++overread;
      bitbuf |= byte << bitsleft;
      bitsleft += 8;
    }
  };
  auto refill_fast = [&]() {  // needs 8 input bytes: keeps >= 56 bits buffered
    bitbuf |= load_le64(in) << bitsleft;
    in += (63 - bitsleft) >> 3;
    bitsleft |= 56;
  };
  auto consume = [&](unsigned n) {
    bitbuf >>= n;
    bitsleft -= n;
  };
  // bits taken from past the end of the input: the stream is truncated
  auto overrun = [&]() { return overread != 0 && bitsleft < 8 * overread; };
  auto fail = [&](int rc) { return Inflated{rc, size_t(out - out_begin), false, 0}; };
  auto full = [&]() { return Inflated{kOk, size_t(out - out_begin), false, 0}; };

  bool final_block = false;
  do {
    refill_slow();
    final_block = bitbuf & 1;
    const unsigned type = (bitbuf >> 1) & 3;
    consume(3);
    if (type == 0) {  // stored: byte-align, LEN, NLEN, LEN raw bytes
      consume(bitsleft & 7);
      if (bitsleft / 8 < overread) return fail(kErrShort);
      in -= bitsleft / 8 - overread;
      bitbuf = 0;
      bitsleft = 0;
      overread = 0;
      if (in_end - in < 4) return fail(kErrShort);
      const size_t len = size_t(in[0]) | size_t(in[1]) << 8;
      const size_t nlen = size_t(in[2]) | size_t(in[3]) << 8;
      in += 4;
      if (len != (~nlen & 0xffff)) return fail(kErrGzip);
      const size_t n = std::min(len, size_t(out_end - out));
      if (size_t(in_end - in) < n) return fail(kErrShort);
      std::memcpy(out, in, n);
      out += n;
      in += n;
      if (n < len) return full();
      continue;
    }
    if (type == 3) return fail(kErrGzip);
    const uint32_t* litlen = fixed_tables().litlen;
    const uint32_t* dist = fixed_tables().dist;
    if (type == 2) {  // dynamic: the code lengths, coded by the precode
      const unsigned hlit = 257 + (bitbuf & 31), hdist = 1 + ((bitbuf >> 5) & 31);
      const unsigned hclen = 4 + ((bitbuf >> 10) & 15);
      consume(14);
      if (hlit > 286 || hdist > 30) return fail(kErrGzip);
      uint8_t pre_lens[19] = {0};
      for (unsigned i = 0; i < hclen; ++i) {
        if (bitsleft < 3) refill_slow();
        pre_lens[kPrecodeOrder[i]] = bitbuf & 7;
        consume(3);
      }
      if (!build_table(precode, kPrecodeEnough, kPrecodeBits, pre_lens, 19, syms.precode, true))
        return fail(kErrGzip);
      uint8_t lens[286 + 30];
      for (unsigned i = 0; i < hlit + hdist;) {
        refill_slow();
        const uint32_t e = precode[bitbuf & ((1u << kPrecodeBits) - 1)];
        if (!(e & kLit)) return fail(kErrGzip);
        consume(e & 63);
        const unsigned sym = e >> 16;
        if (sym < 16) {
          lens[i++] = uint8_t(sym);
          continue;
        }
        unsigned rep;
        uint8_t val = 0;
        if (sym == 16) {
          if (i == 0) return fail(kErrGzip);
          val = lens[i - 1];
          rep = 3 + (bitbuf & 3);
          consume(2);
        } else if (sym == 17) {
          rep = 3 + (bitbuf & 7);
          consume(3);
        } else {
          rep = 11 + (bitbuf & 127);
          consume(7);
        }
        if (i + rep > hlit + hdist) return fail(kErrGzip);
        std::fill_n(lens + i, rep, val);
        i += rep;
      }
      if (overrun()) return fail(kErrShort);
      if (lens[256] == 0) return fail(kErrGzip);  // no end-of-block code
      if (!build_table(litlen_dyn, kLitlenEnough, kLitlenBits, lens, hlit, syms.litlen, false) ||
          !build_table(dist_dyn, kDistEnough, kDistBits, lens + hlit, hdist, syms.dist, false))
        return fail(kErrGzip);
      litlen = litlen_dyn;
      dist = dist_dyn;
    }

    // The symbols.  After a refill at least 56 bits are buffered, and one
    // length/distance pair takes at most 15 + 5 + 15 + 13 = 48 of them.
    for (;;) {
      // Fast loop, while 8 input bytes and a whole match (word copies
      // included) fit: whole-word refills, no bounds checks, and the next
      // entry looked up before the refill that precedes its use (the refill
      // leaves the low bits alone), so the lookup does not wait on it.
      if (in_end - in >= 8 && size_t(out_end - out) >= kFastOutSlack) {
        refill_fast();
        uint32_t e = litlen[bitbuf & kLitlenMask];
        for (;;) {
          refill_fast();
          if (e & kLit) {  // up to three literals of <= 11 bits each
            consume(e & 63);
            const uint32_t e2 = litlen[bitbuf & kLitlenMask];
            *out++ = uint8_t(e >> 16);
            e = e2;
            if (e & kLit) {
              consume(e & 63);
              const uint32_t e3 = litlen[bitbuf & kLitlenMask];
              *out++ = uint8_t(e >> 16);
              e = e3;
              if (e & kLit) {
                consume(e & 63);
                const uint32_t e4 = litlen[bitbuf & kLitlenMask];
                *out++ = uint8_t(e >> 16);
                e = e4;
              }
            }
            if (in_end - in >= 8 && size_t(out_end - out) >= kFastOutSlack) continue;
            break;
          }
          if (e & kSub) {
            consume(kLitlenBits);
            e = litlen[(e >> 16) + (bitbuf & ((1u << ((e >> 8) & 15)) - 1))];
          }
          if (e & kLit) {
            consume(e & 63);
            *out++ = uint8_t(e >> 16);
          } else if (e & kEob) {
            consume(e & 63);
            goto block_done;
          } else {
            if (!(e & kBase)) return fail(kErrGzip);
            unsigned clen = e & 63, extra = (e >> 8) & 15;
            const size_t length = (e >> 16) + ((bitbuf >> clen) & ((1u << extra) - 1));
            consume(clen + extra);
            e = dist[bitbuf & kDistMask];
            if (e & kSub) {
              consume(kDistBits);
              e = dist[(e >> 16) + (bitbuf & ((1u << ((e >> 8) & 15)) - 1))];
            }
            if (!(e & kBase)) return fail(kErrGzip);
            clen = e & 63;
            extra = (e >> 8) & 15;
            const size_t distance = (e >> 16) + ((bitbuf >> clen) & ((1u << extra) - 1));
            consume(clen + extra);
            if (distance > size_t(out - out_begin)) return fail(kErrGzip);  // too far back
            const uint8_t* src = out - distance;
            uint8_t* dst = out;
            out += length;
            if (distance >= 8) {
              do {  // may write up to 7 bytes past the match: inside the slack
                uint64_t w;
                std::memcpy(&w, src, 8);
                std::memcpy(dst, &w, 8);
                src += 8;
                dst += 8;
              } while (dst < out);
            } else if (distance == 1) {
              std::memset(dst, *src, length);
            } else {
              for (; dst < out; ++dst, ++src) *dst = *src;
            }
          }
          if (!(in_end - in >= 8 && size_t(out_end - out) >= kFastOutSlack)) break;
          refill_fast();
          e = litlen[bitbuf & kLitlenMask];
        }
        continue;  // re-check: the fast loop or one symbol of the checked path
      }

      // Checked path: one symbol, near the end of the input or the output.
      refill_slow();
      uint32_t e = litlen[bitbuf & kLitlenMask];
      if (e & kSub) {
        consume(kLitlenBits);
        e = litlen[(e >> 16) + (bitbuf & ((1u << ((e >> 8) & 15)) - 1))];
      }
      if (e & kLit) {
        consume(e & 63);
        if (overrun()) return fail(kErrShort);
        if (out == out_end) return full();
        *out++ = uint8_t(e >> 16);
        continue;
      }
      if (e & kEob) {
        consume(e & 63);
        if (overrun()) return fail(kErrShort);
        break;
      }
      if (!(e & kBase)) return fail(kErrGzip);
      unsigned clen = e & 63, extra = (e >> 8) & 15;
      const size_t length = (e >> 16) + ((bitbuf >> clen) & ((1u << extra) - 1));
      consume(clen + extra);
      e = dist[bitbuf & kDistMask];
      if (e & kSub) {
        consume(kDistBits);
        e = dist[(e >> 16) + (bitbuf & ((1u << ((e >> 8) & 15)) - 1))];
      }
      if (!(e & kBase)) return fail(kErrGzip);
      clen = e & 63;
      extra = (e >> 8) & 15;
      const size_t distance = (e >> 16) + ((bitbuf >> clen) & ((1u << extra) - 1));
      consume(clen + extra);
      if (overrun()) return fail(kErrShort);
      if (out == out_end) return full();
      if (distance > size_t(out - out_begin)) return fail(kErrGzip);  // too far back
      const uint8_t* src = out - distance;
      const size_t n = std::min(length, size_t(out_end - out));
      for (size_t i = 0; i < n; ++i) out[i] = src[i];
      out += n;
      if (n < length) return full();
    }
  block_done:;
  } while (!final_block);

  consume(bitsleft & 7);
  if (bitsleft / 8 < overread) return fail(kErrShort);
  in -= bitsleft / 8 - overread;
  return Inflated{kOk, size_t(out - out_begin), true, size_t(in - in_begin)};
}

bool is_gzip(const uint8_t* buf, size_t len) {
  return len >= 2 && buf[0] == 0x1f && buf[1] == 0x8b;
}

// Decode the first gzip member of src into dst[0..dst_len) (prefix
// semantics above).  Returns the bytes produced, or a negative ErrorCode.
long gunzip_prefix(const uint8_t* src, size_t src_len, uint8_t* dst, size_t dst_len) {
  if (src_len < 10) return kErrShort;
  if (!is_gzip(src, src_len) || src[2] != 8) return kErrGzip;  // CM 8: deflate
  const uint8_t flags = src[3];
  if (flags & 0xe0) return kErrGzip;  // reserved bits
  size_t pos = 10;
  if (flags & 0x04) {  // FEXTRA
    if (src_len - pos < 2) return kErrShort;
    const size_t xlen = size_t(src[pos]) | size_t(src[pos + 1]) << 8;
    pos += 2;
    if (src_len - pos < xlen) return kErrShort;
    pos += xlen;
  }
  for (uint8_t flag : {uint8_t(0x08), uint8_t(0x10)}) {  // FNAME, FCOMMENT
    if (!(flags & flag)) continue;
    while (pos < src_len && src[pos] != 0) ++pos;
    if (pos >= src_len) return kErrShort;
    ++pos;
  }
  if (flags & 0x02) {  // FHCRC: the low 16 bits of the header's CRC-32
    if (src_len - pos < 2) return kErrShort;
    if ((crc32(src, pos) & 0xffff) != (uint32_t(src[pos]) | uint32_t(src[pos + 1]) << 8))
      return kErrGzip;
    pos += 2;
  }
  const Inflated r = inflate_raw(src + pos, src_len - pos, dst, dst_len);
  if (r.rc != kOk) return r.rc;
  if (r.ended) {  // the member ended inside the output: check its trailer
    const size_t at = pos + r.in_used;
    if (src_len - at < 8) return kErrShort;
    if (load_le32(src + at) != crc32(dst, r.produced) ||
        load_le32(src + at + 4) != uint32_t(r.produced))
      return kErrGzip;
  }
  return static_cast<long>(r.produced);
}

// ------------------------------------------------------------- NIfTI

struct Buffer {
  std::unique_ptr<uint8_t[]> data;  // not zero-filled: every byte is written before it is read
  size_t size = 0;
};

// Read a whole file into memory.
int read_file(const char* path, Buffer& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kErrOpen;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size <= 0) {
    std::fclose(f);
    return kErrShort;
  }
  out.data.reset(new uint8_t[size_t(size)]);
  out.size = size_t(size);
  const size_t got = std::fread(out.data.get(), 1, out.size, f);
  std::fclose(f);
  return got == out.size ? kOk : kErrShort;
}

template <typename T>
void convert_to_f32(const uint8_t* raw, float* dst, int64_t n, float slope, float inter) {
  T v;
  if (slope == 1.0f && inter == 0.0f) {
    for (int64_t i = 0; i < n; ++i) {
      std::memcpy(&v, raw + i * sizeof(T), sizeof(T));
      dst[i] = static_cast<float>(v);
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      std::memcpy(&v, raw + i * sizeof(T), sizeof(T));
      dst[i] = static_cast<float>(v) * slope + inter;
    }
  }
}

int dtype_itemsize(int code) {
  switch (code) {
    case 2: case 256: return 1;          // u8 / i8
    case 4: case 512: return 2;          // i16 / u16
    case 8: case 768: case 16: return 4; // i32 / u32 / f32
    case 64: return 8;                   // f64
    default: return 0;
  }
}

int convert(int code, const uint8_t* raw, float* dst, int64_t n, float slope, float inter) {
  switch (code) {
    case 2:   convert_to_f32<uint8_t>(raw, dst, n, slope, inter); return kOk;
    case 4:   convert_to_f32<int16_t>(raw, dst, n, slope, inter); return kOk;
    case 8:   convert_to_f32<int32_t>(raw, dst, n, slope, inter); return kOk;
    case 16:  convert_to_f32<float>(raw, dst, n, slope, inter); return kOk;
    case 64:  convert_to_f32<double>(raw, dst, n, slope, inter); return kOk;
    case 256: convert_to_f32<int8_t>(raw, dst, n, slope, inter); return kOk;
    case 512: convert_to_f32<uint16_t>(raw, dst, n, slope, inter); return kOk;
    case 768: convert_to_f32<uint32_t>(raw, dst, n, slope, inter); return kOk;
    default:  return kErrDtype;
  }
}

struct HeaderInfo {
  int16_t dim[8];
  int16_t datatype;
  float vox_offset;
  float scl_slope;
  float scl_inter;
};

int parse_header(const uint8_t* hdr, HeaderInfo* info) {
  int32_t sizeof_hdr;
  std::memcpy(&sizeof_hdr, hdr, 4);
  if (sizeof_hdr != kHeaderSize) return kErrHeader;  // big-endian: the caller's codec
  std::memcpy(info->dim, hdr + 40, 16);
  std::memcpy(&info->datatype, hdr + 70, 2);
  std::memcpy(&info->vox_offset, hdr + 108, 4);
  std::memcpy(&info->scl_slope, hdr + 112, 4);
  std::memcpy(&info->scl_inter, hdr + 116, 4);
  return kOk;
}

// The voxel count of an (untrusted) header, or a negative error when dims or
// vox_offset are out of range; cap_voxels bounds the product so that a
// hostile header cannot drive a huge allocation.
int64_t checked_voxel_count(const HeaderInfo& info, int64_t cap_voxels) {
  const int ndim = info.dim[0];
  if (ndim < 1 || ndim > 7) return kErrHeader;
  int64_t n = 1;
  for (int d = 1; d <= ndim; ++d) {
    const int64_t dv = info.dim[d];
    if (dv < 1) return kErrHeader;
    n *= dv;
    if (n > cap_voxels) return kErrAlloc;
  }
  if (!std::isfinite(info.vox_offset) || info.vox_offset < kHeaderSize ||
      info.vox_offset > (1 << 20))
    return kErrHeader;
  return n;
}

// Decode one NIfTI file (gzipped or not) into a caller-provided float32
// buffer of capacity cap_voxels; copies the header into hdr348 (if not
// null).  Returns the voxel count or a negative error.
int64_t decode_one(const char* path, float* dst, int64_t cap_voxels, uint8_t* hdr348) try {
  Buffer file;
  int rc = read_file(path, file);
  if (rc != kOk) return rc;

  Buffer plain;
  const uint8_t* data = file.data.get();
  size_t data_len = file.size;
  if (is_gzip(file.data.get(), file.size)) {
    uint8_t hdr[kHeaderSize];  // the header first, to learn the payload's size
    if (gunzip_prefix(file.data.get(), file.size, hdr, kHeaderSize) != kHeaderSize)
      return kErrHeader;
    HeaderInfo info;
    if (parse_header(hdr, &info) != kOk) return kErrHeader;
    const int isz = dtype_itemsize(info.datatype);
    if (!isz) return kErrDtype;
    const int64_t n = checked_voxel_count(info, cap_voxels);
    if (n < 0) return n;
    const size_t total = static_cast<size_t>(info.vox_offset) + static_cast<size_t>(n) * isz;
    plain.data.reset(new uint8_t[total]);
    plain.size = total;
    const long got = gunzip_prefix(file.data.get(), file.size, plain.data.get(), total);
    if (got < 0) return got;
    if (got < static_cast<long>(total)) return kErrShort;
    data = plain.data.get();
    data_len = plain.size;
  }
  if (data_len < static_cast<size_t>(kHeaderSize)) return kErrShort;

  HeaderInfo info;
  if (parse_header(data, &info) != kOk) return kErrHeader;
  if (hdr348) std::memcpy(hdr348, data, kHeaderSize);
  const int isz = dtype_itemsize(info.datatype);
  if (!isz) return kErrDtype;
  const int64_t n = checked_voxel_count(info, cap_voxels);
  if (n < 0) return n;
  const size_t offset = static_cast<size_t>(info.vox_offset);
  if (data_len < offset + static_cast<size_t>(n) * isz) return kErrShort;

  float slope = info.scl_slope;
  float inter = info.scl_inter;
  // nibabel semantics: slope 0/NaN means no scaling; non-finite inter is 0.
  if (!std::isfinite(slope) || slope == 0.0f) slope = 1.0f;
  if (!std::isfinite(inter)) inter = 0.0f;
  rc = convert(info.datatype, data + offset, dst, n, slope, inter);
  if (rc != kOk) return rc;
  return n;
} catch (...) {
  // std::bad_alloc etc. must not cross the extern-C boundary.
  return kErrAlloc;
}

// A finite float32 as a uint32 key that sorts as the floats do: a negative
// float has every bit flipped, a non-negative one its sign bit set, and -0.0
// (key 0x7fffffff) takes +0.0's key, as the two tie under a sort.
constexpr int kKeyBins = 1 << 16;

inline uint32_t order_key(float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, sizeof bits);
  const uint32_t key = bits ^ ((0u - (bits >> 31)) | 0x80000000u);
  return key + (key == 0x7fffffffu);
}

inline float key_value(uint32_t key) {
  const uint32_t bits = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  float v;
  std::memcpy(&v, &bits, sizeof v);
  return v;
}

}  // namespace

extern "C" {

// Header-only probe: fills hdr348; returns 0 or an error.
int fastio_read_header(const char* path, uint8_t* hdr348) try {
  Buffer file;
  const int rc = read_file(path, file);
  if (rc != kOk) return rc;
  if (is_gzip(file.data.get(), file.size))
    return gunzip_prefix(file.data.get(), file.size, hdr348, kHeaderSize) == kHeaderSize
               ? kOk
               : kErrHeader;
  if (file.size < static_cast<size_t>(kHeaderSize)) return kErrShort;
  std::memcpy(hdr348, file.data.get(), kHeaderSize);
  return kOk;
} catch (...) {
  return kErrAlloc;
}

// Decode one volume to float32 (scaled).  Returns the voxel count or an error.
int64_t fastio_decode(const char* path, float* dst, int64_t cap_voxels, uint8_t* hdr348) {
  return decode_one(path, dst, cap_voxels, hdr348);
}

// Decode a batch of volumes in parallel.  dst buffers and headers are
// caller-provided arrays of pointers; results[i] gets the voxel count or a
// negative error code per file.
void fastio_decode_batch(const char** paths, int n_files, float** dsts, const int64_t* caps,
                         uint8_t** hdrs, int64_t* results, int n_threads) {
  if (n_files <= 0) return;
  if (n_threads <= 0) n_threads = static_cast<int>(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min(n_threads, n_files));
  std::atomic<int> next{0};
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n_files) return;
      results[i] = decode_one(paths[i], dsts[i], caps[i], hdrs ? hdrs[i] : nullptr);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();  // the calling thread takes its share
  for (auto& th : pool) th.join();
}

// The first gzip member of src[0..src_len) into dst[0..dst_cap) (prefix
// semantics).  Returns the bytes produced or a negative error.
int64_t fastio_gunzip(const uint8_t* src, int64_t src_len, uint8_t* dst, int64_t dst_cap) try {
  if (!src || !dst || src_len < 0 || dst_cap < 0) return kErrHeader;
  return gunzip_prefix(src, size_t(src_len), dst, size_t(dst_cap));
} catch (...) {
  return kErrAlloc;
}

// Exact order statistics for float32 data: for each requested 0-based rank
// in idx[0..k) (sorted ascending, each in [0, n)), write the value that a
// full ascending sort would place at that rank into out[i].  A two-pass
// radix select on order_key, reading the data in its stored order and
// allocating nothing of size n:
//   1. count the high 16 bits of every key (65,536 bins, 256 KB); a prefix
//      walk gives each rank its high bin and its rank inside that bin;
//   2. count the low 16 bits of the keys whose high bin holds a rank (at most
//      k bins, 256 KB each); a second walk gives each rank's exact key.
// Equal values are counts, so runs of them (a scan's zero background) need
// nothing special.  Counts are 32-bit, so n is below 2^32.  Non-finite
// values (NaN has no place in the order, inf breaks the caller's lerp) are
// refused in pass 1: kErrData, and the caller takes np.percentile.  Returns
// 0, or a negative error on bad arguments or data.
int fastio_order_stats(const float* data, int64_t n, const int64_t* idx, int k, float* out) try {
  if (n <= 0 || n > INT64_C(0xffffffff) || k <= 0) return kErrHeader;
  for (int i = 0; i < k; ++i) {
    if (idx[i] < 0 || idx[i] >= n) return kErrHeader;
    if (i > 0 && idx[i] < idx[i - 1]) return kErrHeader;
  }
  std::vector<uint32_t> high(kKeyBins);
  for (int64_t i = 0; i < n; ++i) {
    if (!std::isfinite(data[i])) return kErrData;
    ++high[order_key(data[i]) >> 16];
  }
  // rank i lies in high bin bin[i], as the rest[i]-th key of that bin
  std::vector<uint32_t> bin(k), rest(k);
  int64_t below = 0;
  for (int i = 0, b = 0; i < k; ++i) {
    while (below + high[b] <= idx[i]) below += high[b++];
    bin[i] = b;
    rest[i] = static_cast<uint32_t>(idx[i] - below);
  }
  std::vector<int32_t> slot(kKeyBins, -1);  // a target bin's place in low
  int32_t n_targets = 0;
  for (int i = 0; i < k; ++i)
    if (slot[bin[i]] < 0) slot[bin[i]] = n_targets++;
  std::vector<uint32_t> low(static_cast<size_t>(n_targets) * kKeyBins);
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t key = order_key(data[i]);
    const int32_t t = slot[key >> 16];
    if (t >= 0) ++low[static_cast<size_t>(t) * kKeyBins + (key & 0xffffu)];
  }
  for (int i = 0; i < k; ++i) {
    const uint32_t* counts = low.data() + static_cast<size_t>(slot[bin[i]]) * kKeyBins;
    uint32_t seen = 0, b = 0;
    while (seen + counts[b] <= rest[i]) seen += counts[b++];
    out[i] = key_value((bin[i] << 16) | b);
  }
  return kOk;
} catch (...) {
  return kErrAlloc;
}

// Single-pass quantize + pad for the serving upload
// (ops/fused.py:FusedVolumePipeline.prepare): the numpy chain clip -> -= lo
// -> *= scale -> += 0.5 -> uint16 cast into a zeroed padded buffer, as one
// strided read of the float32 source and one sequential write of the
// C-ordered destination, the padding zero-filled.  The same four float32
// operations in the same order (fp-contract off), and the final cast
// truncates as numpy's does, so the result is numpy's bit for bit.  scale
// arrives precomputed: numpy derives it as f32(65535.0 / (hi - lo)) in
// float64.  Returns 0 or a negative error.
int fastio_quantize_pad(const float* src, const int64_t* dims, const int64_t* strides_el,
                        uint16_t* dst, const int64_t* pdims, float lo, float hi, float scale) {
  if (!src || !dst || !dims || !strides_el || !pdims) return kErrHeader;
  const int64_t d0 = dims[0], d1 = dims[1], d2 = dims[2];
  const int64_t p0 = pdims[0], p1 = pdims[1], p2 = pdims[2];
  if (d0 <= 0 || d1 <= 0 || d2 <= 0 || d0 > p0 || d1 > p1 || d2 > p2) return kErrHeader;
  const int64_t s0 = strides_el[0], s1 = strides_el[1], s2 = strides_el[2];

  auto quant = [lo, hi, scale](float v) -> uint16_t {
    if (v < lo) v = lo;
    if (v > hi) v = hi;
    v = v - lo;
    v = v * scale;
    v = v + 0.5f;
    return static_cast<uint16_t>(v);
  };

  // zero the padding margins only
  for (int64_t i = d0; i < p0; ++i)
    std::memset(dst + i * p1 * p2, 0, static_cast<size_t>(p1) * p2 * sizeof(uint16_t));
  for (int64_t i = 0; i < d0; ++i) {
    uint16_t* plane = dst + i * p1 * p2;
    for (int64_t j = d1; j < p1; ++j)
      std::memset(plane + j * p2, 0, static_cast<size_t>(p2) * sizeof(uint16_t));
    if (d2 < p2)
      for (int64_t j = 0; j < d1; ++j)
        std::memset(plane + j * p2 + d2, 0, static_cast<size_t>(p2 - d2) * sizeof(uint16_t));
  }

  if (s0 == 1 && d0 > 1) {
    // Fortran-contiguous source (decoded NIfTI volumes): out[i,j,k] =
    // src[i + j*s1 + k*s2] transposes the source's contiguous axis (i) into
    // the destination's (k); 64x64 (i, k) tiles per j keep both sides in cache.
    constexpr int64_t kTile = 64;
    for (int64_t j = 0; j < d1; ++j) {
      const float* sj = src + j * s1;
      uint16_t* pj = dst + j * p2;
      for (int64_t i0 = 0; i0 < d0; i0 += kTile) {
        const int64_t i1 = std::min(i0 + kTile, d0);
        for (int64_t k0 = 0; k0 < d2; k0 += kTile) {
          const int64_t k1 = std::min(k0 + kTile, d2);
          for (int64_t k = k0; k < k1; ++k) {
            const float* s = sj + k * s2;
            for (int64_t i = i0; i < i1; ++i) pj[i * p1 * p2 + k] = quant(s[i]);
          }
        }
      }
    }
    return kOk;
  }

  for (int64_t i = 0; i < d0; ++i) {
    uint16_t* plane = dst + i * p1 * p2;
    for (int64_t j = 0; j < d1; ++j) {
      uint16_t* row = plane + j * p2;
      const float* s = src + i * s0 + j * s1;
      for (int64_t k = 0; k < d2; ++k) row[k] = quant(s[k * s2]);
    }
  }
  return kOk;
}

}  // extern "C"
