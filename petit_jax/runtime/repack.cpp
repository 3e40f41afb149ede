// Native repack core: reference-layout FP4 checkpoints -> petit layout.
//
// C++ analog of the reference's offline repack kernels
// (lib/gemm/rocm/quantization/quantization_utils.cu:183-304). The
// reference shuffles on-device; here the repack runs on the host at
// checkpoint-load time, so the native implementation is a multithreaded CPU
// transform (a 70B checkpoint is ~35 GB of packed nibbles; numpy does this
// at ~1 GB/s, this core runs at memory speed).
//
// Layout contract (must match ops/layout.py _slot_k + _v6_place exactly,
// see its module doc): out word (r, c), slot s = j + 4h holds the q-coded
// E2M1 nibble of column n=c at
//   k = j*(K/4) + (r/64)*128 + pi(2*(r%64) + h),  pi(i) = (i%8)*16 + i/8,
// with v6 single-shift bit prepositioning inside the 16*h half:
//   j=0: t at {6,7,8},  sign 15;  j=1: t at {3,4,5},  sign 12;
//   j=2: t at {0,1,2},  sign 9;   j=3: t{0,1} at {10,11}, t{2} at 13,
//   sign 14.
// Negative-zero nibbles (0x8) are masked to +0.
//
// Exposed as a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

// q-code magnitude remap (swaps E2M1 codes 0 and 1; self-inverse) —
// must match ops/layout.py Q_OF_M. Applied after negative-zero masking.
constexpr uint8_t kQOfM[8] = {1, 0, 2, 3, 4, 5, 6, 7};

inline uint8_t nib_at(const uint8_t* row, int64_t kk) {
  uint8_t byte = row[kk >> 1];
  uint8_t nib = (kk & 1) ? (byte >> 4) : (byte & 0xF);
  if (nib == 8) nib = 0;  // mask negative zero
  return (nib & 8) | kQOfM[nib & 7];
}

// v6 in-half bit placement (must match ops/layout.py _v6_place).
inline uint32_t v6_place(uint8_t code, int j) {
  const uint32_t t = code & 7, sg = code >> 3;
  switch (j) {
    case 0: return (t << 6) | (sg << 15);
    case 1: return (t << 3) | (sg << 12);
    case 2: return t | (sg << 9);
    default: return ((t & 3) << 10) | ((t >> 2) << 13) | (sg << 14);
  }
}

void repack_rows(const uint8_t* qw, uint32_t* out, int64_t n, int64_t k,
                 int64_t r0, int64_t r1) {
  const int64_t kq = k / 4;
  // Tile over columns to keep qw row segments in cache.
  constexpr int64_t CB = 128;
  for (int64_t c0 = 0; c0 < n; c0 += CB) {
    const int64_t c1 = std::min(c0 + CB, n);
    for (int64_t r = r0; r < r1; ++r) {
      uint32_t* out_row = out + r * n;
      for (int64_t c = c0; c < c1; ++c) {
        const uint8_t* row = qw + c * (k / 2);
        uint32_t w = 0;
        for (int s = 0; s < 8; ++s) {
          const int j = s & 3, h = s >> 2;
          const int64_t i = 2 * (r % 64) + h;
          const int64_t kk = static_cast<int64_t>(j) * kq + (r / 64) * 128 +
                             (i % 8) * 16 + i / 8;
          w |= v6_place(nib_at(row, kk), j) << (16 * h);
        }
        out_row[c] = w;
      }
    }
  }
}

// bf16 bit pattern of an E4M3 byte (positive, non-NaN; exact: 3 mantissa
// bits) or of an E8M0 byte (2^(b-127); byte 0 -> exact 0.0 by contract,
// matching ops/layout.py process_fp4_scales).
inline uint16_t e4m3_to_bf16(uint8_t b) {
  const uint16_t m = b & 7, e = (b >> 3) & 0xF;
  if (e != 0) return static_cast<uint16_t>(((e + 120) << 7) | (m << 4));
  if (m == 0) return 0;
  // subnormal: m/8 * 2^-6 = m * 2^-9; normalize (m in 1..7)
  int sh = (m >= 4) ? 2 : (m >= 2 ? 1 : 0);
  const uint16_t exp = static_cast<uint16_t>(127 - 9 + sh);
  const uint16_t mant = static_cast<uint16_t>((m << (7 - sh)) & 0x7F);
  return static_cast<uint16_t>((exp << 7) | mant);
}

inline uint16_t e8m0_to_bf16(uint8_t b) {
  // byte 0 (2^-127) is below bf16 normal range: emit exact 0.0, so no
  // result depends on a backend's denormal handling
  if (b == 0) return 0;
  return static_cast<uint16_t>(b) << 7;
}

void transpose_scales(const uint8_t* src, uint16_t* dst, int64_t rows,
                      int64_t cols, int group, int64_t r0, int64_t r1) {
  // src (rows, cols) u8 -> dst (cols * dup, rows) bf16; parallel over src
  // rows. MXFP4 (group 32) duplicates each group's scale per 16-element
  // half so the output is stride-16 rows like NVFP4 (ops/layout.py doc).
  const int dup = (group == 32) ? 2 : 1;
  constexpr int64_t TB = 64;
  for (int64_t c0 = 0; c0 < cols; c0 += TB) {
    const int64_t c1 = std::min(c0 + TB, cols);
    for (int64_t r = r0; r < r1; ++r) {
      for (int64_t c = c0; c < c1; ++c) {
        const uint8_t b = src[r * cols + c];
        const uint16_t v =
            (group == 16) ? e4m3_to_bf16(b) : e8m0_to_bf16(b);
        for (int d = 0; d < dup; ++d) dst[(c * dup + d) * rows + r] = v;
      }
    }
  }
}

template <typename F>
void parallel_for(int64_t total, F&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nthreads = std::max<int64_t>(1, std::min<int64_t>(hw, total));
  if (nthreads == 1) {
    fn(0, total);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (total + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    const int64_t lo = t * chunk, hi = std::min(lo + chunk, total);
    if (lo >= hi) break;
    threads.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// qw: (n, k/2) uint8 nibble pairs (low nibble = even k). out: (k/8, n) u32.
// Returns 0 on success, nonzero on invalid shape.
int petit_repack_fp4(const uint8_t* qw, uint32_t* out, int64_t n,
                         int64_t k) {
  if (k <= 0 || n <= 0 || (k % 128) != 0 || (n % 16) != 0) return 1;
  parallel_for(k / 8, [&](int64_t r0, int64_t r1) {
    repack_rows(qw, out, n, k, r0, r1);
  });
  return 0;
}

// scales: (n, k/group) uint8 raw E4M3 (group=16) / E8M0 (group=32) bytes ->
// out (k/16, n) bf16 bits (decode + transpose; MXFP4 rows duplicated per
// half-group). Validation of sign/NaN bytes stays in Python.
int petit_process_scales(const uint8_t* scales, uint16_t* out, int64_t n,
                             int64_t groups, int group) {
  if (n <= 0 || groups <= 0 || (group != 16 && group != 32)) return 1;
  parallel_for(n, [&](int64_t r0, int64_t r1) {
    transpose_scales(scales, out, n, groups, group, r0, r1);
  });
  return 0;
}

}  // extern "C"
