// Native (C++) components of audio_pattern_discovery (SURVEY.md SS3 row 11).
//
// The reference implementation is entirely native (Rust, CPU).  On the
// accelerator the native tier for the *compute path* is XLA-compiled JAX +
// Pallas; this library provides the native *runtime* pieces around it:
//
//   * apd_dtw_batch      — CPU DTW (the Rust-reference-equivalent hot loop).
//                          Serves as (a) the measured CPU baseline that
//                          BASELINE.json's ">=100x Rust CPU baseline" target
//                          is computed against, and (b) a host fallback.
//   * apd_nn_chain       — O(K^2) NN-chain agglomerative clustering with
//                          Lance-Williams updates (bit-compatible with
//                          cluster/agglomerative.py; used for large K).
//   * apd_read_wav_pcm16 — fast RIFF/WAVE PCM16 demux for bulk ingest.
//
// Built with: g++ -O3 -march=native -shared -fPIC (+ -fopenmp for the
// multithreaded batch path).  Bound via ctypes (native/__init__ loader);
// pybind11 is not available in this environment.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#ifdef _OPENMP
#include <omp.h>
#else
// Built without OpenMP (a toolchain without libgomp): loops run serially.
static inline int omp_get_max_threads() { return 1; }
#endif
#endif

extern "C" {

static inline float frame_cost(const float* a, const float* b, int d, int metric) {
  // metric: 0 = euclidean, 1 = sqeuclidean, 2 = cosine
  if (metric == 2) {
    double dot = 0.0, na = 0.0, nb = 0.0;
    for (int k = 0; k < d; ++k) {
      dot += (double)a[k] * b[k];
      na += (double)a[k] * a[k];
      nb += (double)b[k] * b[k];
    }
    if (na == 0.0 || nb == 0.0) return 1.0f;
    return (float)(1.0 - dot / (std::sqrt(na) * std::sqrt(nb)));
  }
  double acc = 0.0;
  for (int k = 0; k < d; ++k) {
    double diff = (double)a[k] - b[k];
    acc += diff * diff;
  }
  return metric == 0 ? (float)std::sqrt(acc) : (float)acc;
}

// Single-pair DTW with Sakoe-Chiba band; rolling two-row buffers (O(M) mem).
// band < 0 disables the band.  Matches oracle/dtw.py semantics exactly.
// band_mode: 0 = "widen" (|i-j| <= max(band, |n-m|)), 1 = "diag" (the scaled
// corridor |j*(n-1) - i*(m-1)| <= max(band,1)*max(n-1, m-1); exact int64
// row bounds, same predicate as oracle/dtw.py band_valid).
float apd_dtw_pair(const float* a, const float* b, int n, int m, int d,
                   int band, int metric, int auto_widen, int band_mode) {
  const float INF = std::numeric_limits<float>::infinity();
  if (n <= 0 || m <= 0) return INF;  // no feasible path (matches the jnp path)
  int w = band < 0 ? std::max(n, m) : band;
  if (band >= 0 && auto_widen) w = std::max(w, std::abs(n - m));
  const int64_t den = n - 1, num = m - 1;
  const int64_t rmx =
      (int64_t)std::max(band, 1) * std::max(den, num);  // diag threshold

  std::vector<float> prev(m, INF), cur(m, INF);
  for (int i = 0; i < n; ++i) {
    int jlo, jhi;
    if (band >= 0 && band_mode == 1) {
      if (den == 0) {
        jlo = 0;
        jhi = m - 1;  // 1 x m grid: every cell is on the corridor
      } else {
        // |j*den - i*num| <= rmx  ->  j in [ceil((i*num - rmx)/den),
        //                                   floor((i*num + rmx)/den)]
        int64_t lo = (int64_t)i * num - rmx;
        int64_t hi = (int64_t)i * num + rmx;
        jlo = (int)std::max<int64_t>(0, (lo + den - 1) / den);
        jhi = (int)std::min<int64_t>(m - 1, hi / den);
      }
    } else {
      jlo = std::max(0, i - w);
      jhi = std::min(m - 1, i + w);
    }
    std::fill(cur.begin(), cur.end(), INF);
    for (int j = jlo; j <= jhi; ++j) {
      float c = frame_cost(a + (size_t)i * d, b + (size_t)j * d, d, metric);
      float pred;
      if (i == 0 && j == 0) {
        pred = 0.0f;
      } else {
        pred = prev[j];                                   // (i-1, j)
        if (j > 0) pred = std::min(pred, cur[j - 1]);     // (i, j-1)
        if (j > 0) pred = std::min(pred, prev[j - 1]);    // (i-1, j-1)
      }
      cur[j] = c + pred;
    }
    std::swap(prev, cur);
  }
  return prev[m - 1];
}

// Batched CPU DTW over padded sequences [B, S, d]; out[B] distances.
// n_threads <= 0 uses all cores; 1 gives the single-core reference baseline.
void apd_dtw_batch(const float* a, const float* b, const int32_t* len_a,
                   const int32_t* len_b, float* out, int B, int S, int d,
                   int band, int metric, int auto_widen, int normalize,
                   int n_threads, int band_mode) {
#ifdef _OPENMP
  int nt = n_threads > 0 ? n_threads : omp_get_max_threads();
#pragma omp parallel for schedule(dynamic) num_threads(nt)
#endif
  for (int p = 0; p < B; ++p) {
    const float* ap = a + (size_t)p * S * d;
    const float* bp = b + (size_t)p * S * d;
    float dist = apd_dtw_pair(ap, bp, len_a[p], len_b[p], d, band, metric,
                              auto_widen, band_mode);
    if (normalize == 1) dist /= (float)(len_a[p] + len_b[p]);
    out[p] = dist;
  }
}

// ---------------------------------------------------------------------------
// NN-chain agglomerative clustering (Lance-Williams).
// dist: [K*K] row-major symmetric; Z_out: [(K-1)*4] scipy-style rows in
// merge order BEFORE height-sorting/relabeling (the Python wrapper applies
// the same postprocessing as cluster/agglomerative.py).
// linkage: 0 single, 1 complete, 2 average, 3 weighted.
// Returns 0 on success.
int apd_nn_chain(const double* dist, int K, int linkage, double* Z_out) {
  if (K < 2) return 0;
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> D((size_t)K * K);
  std::memcpy(D.data(), dist, sizeof(double) * (size_t)K * K);
  for (int i = 0; i < K; ++i) D[(size_t)i * K + i] = INF;

  std::vector<int64_t> size(K, 1);
  std::vector<char> active(K, 1);
  std::vector<int> chain;
  chain.reserve(K);
  int n_merged = 0;

  while (n_merged < K - 1) {
    if (chain.empty()) {
      for (int i = 0; i < K; ++i)
        if (active[i]) {
          chain.push_back(i);
          break;
        }
    }
    int x, y;
    double dxy;
    for (;;) {
      x = chain.back();
      const double* row = &D[(size_t)x * K];
      y = -1;
      dxy = INF;
      for (int z = 0; z < K; ++z) {
        if (!active[z] || z == x) continue;
        if (row[z] < dxy) {
          dxy = row[z];
          y = z;
        }
      }
      if (y < 0) {
        // Every remaining distance from x is +inf (e.g. banded DTW with
        // infeasible pairs): fall back to the first active partner, the
        // same choice the Python argmin makes on an all-inf row.
        for (int z = 0; z < K; ++z) {
          if (active[z] && z != x) {
            y = z;
            break;
          }
        }
        if (y < 0) return 1;  // no active partner left: inconsistent state
      }
      if (chain.size() > 1 && D[(size_t)x * K + chain[chain.size() - 2]] == dxy)
        y = chain[chain.size() - 2];
      if (chain.size() > 1 && y == chain[chain.size() - 2]) break;
      chain.push_back(y);
    }
    chain.pop_back();
    chain.pop_back();

    int64_t sx = size[x], sy = size[y];
    Z_out[n_merged * 4 + 0] = x;
    Z_out[n_merged * 4 + 1] = y;
    Z_out[n_merged * 4 + 2] = dxy;
    Z_out[n_merged * 4 + 3] = (double)(sx + sy);
    ++n_merged;

    for (int z = 0; z < K; ++z) {
      double a_ = D[(size_t)x * K + z];
      double b_ = D[(size_t)y * K + z];
      double nv;
      switch (linkage) {
        case 0: nv = std::min(a_, b_); break;
        case 1: nv = std::max(a_, b_); break;
        case 2: nv = (sx * a_ + sy * b_) / (double)(sx + sy); break;
        default: nv = 0.5 * (a_ + b_); break;
      }
      D[(size_t)y * K + z] = nv;
      D[(size_t)z * K + y] = nv;
    }
    D[(size_t)y * K + y] = INF;
    active[x] = 0;
    size[y] = sx + sy;
    size[x] = 0;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Minimal RIFF/WAVE PCM16 demuxer: mono-downmixed float32 output.
// Returns n_samples on success (out may be null to query size), -1 on error.
// sample_rate_out receives the rate.
int64_t apd_read_wav_pcm16(const uint8_t* raw, int64_t raw_len, float* out,
                           int32_t* sample_rate_out) {
  if (raw_len < 12 || std::memcmp(raw, "RIFF", 4) != 0 ||
      std::memcmp(raw + 8, "WAVE", 4) != 0)
    return -1;
  int64_t pos = 12;
  int n_channels = 0, bits = 0;
  int32_t rate = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;
  while (pos + 8 <= raw_len) {
    uint32_t chunk_size;
    std::memcpy(&chunk_size, raw + pos + 4, 4);
    if (std::memcmp(raw + pos, "fmt ", 4) == 0 && chunk_size >= 16) {
      if (pos + 8 + 16 > raw_len) return -1;  // truncated fmt chunk
      uint16_t fmt, ch, ba, bi;
      uint32_t sr;
      std::memcpy(&fmt, raw + pos + 8, 2);
      std::memcpy(&ch, raw + pos + 10, 2);
      std::memcpy(&sr, raw + pos + 12, 4);
      std::memcpy(&ba, raw + pos + 20, 2);
      std::memcpy(&bi, raw + pos + 22, 2);
      if (fmt != 1 || bi != 16) return -1;  // PCM16 only; python handles rest
      n_channels = ch;
      rate = (int32_t)sr;
    } else if (std::memcmp(raw + pos, "data", 4) == 0) {
      data = raw + pos + 8;
      // Clamp the declared size to the bytes actually present: truncated
      // files and streaming WAVs with placeholder sizes (0xFFFFFFFF) must
      // not drive reads past the buffer.
      uint64_t avail = (uint64_t)(raw_len - pos - 8);
      data_len = (uint32_t)std::min<uint64_t>(chunk_size, avail);
    }
    pos += 8 + chunk_size + (chunk_size & 1);
  }
  if (!data || n_channels == 0) return -1;
  int64_t n_frames = (int64_t)data_len / (2 * n_channels);
  if (sample_rate_out) *sample_rate_out = rate;
  if (out) {
    const float scale = 1.0f / (32768.0f * n_channels);
    for (int64_t t = 0; t < n_frames; ++t) {
      int32_t acc = 0;
      for (int c = 0; c < n_channels; ++c) {
        int16_t v;
        std::memcpy(&v, data + 2 * (t * n_channels + c), 2);
        acc += v;
      }
      out[t] = acc * scale;
    }
  }
  return n_frames;
}

// Header-only probe on a file *prefix*: walks RIFF chunks and stops at the
// "data" chunk header (its declared size is enough — the body need not be in
// the buffer).  Returns mono sample count, or -1 if not parseable PCM16.
int64_t apd_wav_header_info(const uint8_t* raw, int64_t raw_len,
                            int32_t* sample_rate_out) {
  if (raw_len < 12 || std::memcmp(raw, "RIFF", 4) != 0 ||
      std::memcmp(raw + 8, "WAVE", 4) != 0)
    return -1;
  int64_t pos = 12;
  int n_channels = 0;
  int32_t rate = 0;
  while (pos + 8 <= raw_len) {
    uint32_t chunk_size;
    std::memcpy(&chunk_size, raw + pos + 4, 4);
    if (std::memcmp(raw + pos, "fmt ", 4) == 0) {
      if (pos + 8 + 16 > raw_len || chunk_size < 16) return -1;
      uint16_t fmt, ch, bi;
      uint32_t sr;
      std::memcpy(&fmt, raw + pos + 8, 2);
      std::memcpy(&ch, raw + pos + 10, 2);
      std::memcpy(&sr, raw + pos + 12, 4);
      std::memcpy(&bi, raw + pos + 22, 2);
      if (fmt != 1 || bi != 16) return -1;
      n_channels = ch;
      rate = (int32_t)sr;
    } else if (std::memcmp(raw + pos, "data", 4) == 0) {
      if (n_channels <= 0) return -1;
      if (sample_rate_out) *sample_rate_out = rate;
      return (int64_t)chunk_size / (2 * n_channels);
    }
    pos += 8 + chunk_size + (chunk_size & 1);
  }
  return -1;
}

static std::vector<uint8_t> read_file_bytes(const char* path, int64_t max_bytes) {
  std::vector<uint8_t> buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  if (max_bytes < 0) {
    std::fseek(f, 0, SEEK_END);
    max_bytes = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
  }
  buf.resize((size_t)max_bytes);
  size_t got = std::fread(buf.data(), 1, (size_t)max_bytes, f);
  std::fclose(f);
  buf.resize(got);
  return buf;
}

// Parallel header probe: per-file mono sample counts + rates.
// n_samples[i] = -1 for unreadable / non-PCM16 files.  Returns #failures.
int apd_wav_info_batch(const char* const* paths, int n_files,
                       int64_t* n_samples, int32_t* rates, int n_threads) {
  int n_fail = 0;
#ifdef _OPENMP
  int nt = n_threads > 0 ? n_threads : omp_get_max_threads();
#pragma omp parallel for schedule(dynamic) reduction(+ : n_fail) num_threads(nt)
#endif
  for (int i = 0; i < n_files; ++i) {
    std::vector<uint8_t> head = read_file_bytes(paths[i], 64 * 1024);
    int32_t rate = 0;
    int64_t n = apd_wav_header_info(head.data(), (int64_t)head.size(), &rate);
    n_samples[i] = n;
    rates[i] = rate;
    if (n < 0) ++n_fail;
  }
  return n_fail;
}

// Bulk parallel ingest (the native data loader, SURVEY.md SS3 rows 1 & 11):
// read + decode n_files PCM16 WAVs into the caller's zero-filled row-major
// [n_files, stride] float32 array.  Clips longer than stride are truncated;
// lengths[i] receives the stored sample count (-1 on failure).  Returns the
// number of failed files.
int apd_wav_load_batch(const char* const* paths, int n_files, float* out,
                       int64_t stride, int32_t* lengths, int32_t* rates,
                       int n_threads) {
  int n_fail = 0;
#ifdef _OPENMP
  int nt = n_threads > 0 ? n_threads : omp_get_max_threads();
#pragma omp parallel for schedule(dynamic) reduction(+ : n_fail) num_threads(nt)
#endif
  for (int i = 0; i < n_files; ++i) {
    std::vector<uint8_t> raw = read_file_bytes(paths[i], -1);
    int32_t rate = 0;
    int64_t n =
        apd_read_wav_pcm16(raw.data(), (int64_t)raw.size(), nullptr, &rate);
    if (n < 0) {
      lengths[i] = -1;
      rates[i] = 0;
      ++n_fail;
      continue;
    }
    std::vector<float> tmp((size_t)n);
    apd_read_wav_pcm16(raw.data(), (int64_t)raw.size(), tmp.data(), &rate);
    int64_t keep = std::min(n, stride);
    std::memcpy(out + (size_t)i * stride, tmp.data(), sizeof(float) * keep);
    lengths[i] = (int32_t)keep;
    rates[i] = rate;
  }
  return n_fail;
}

// ---------------------------------------------------------------------------
// Distance-matrix block scatter (SURVEY.md SS8 "blockwise streaming").
//
// The tiled pair scheduler downloads [U, ti, ti] DTW blocks and assembles the
// symmetric K x K matrix on host.  The NumPy path costs ~6 memory passes per
// block (normalize temp, triu/transpose copies, fancy-indexed mirrored
// writes); at contract scale (50M pairs) that put host scatter at ~1/3 of
// wall, and the K=40k strip path at 418 s (BASELINE.md round 3/4).  These
// two fused single-pass writers read each block once and emit both mirrored
// destinations directly, with path-length normalization inlined.
// ---------------------------------------------------------------------------

// Direct-write mode (D fits comfortably in host RAM): one [nr, nc] block of
// tile-pair (I, J) lands in BOTH triangles of D through the sorted->original
// permutation rows pr/pc.  diag=1 (I == J): the strict upper triangle is
// mirrored and the tile diagonal written as exact zeros, so D stays exactly
// symmetric regardless of last-ulp kernel asymmetries (same contract as the
// NumPy path it replaces in parallel/pair_scheduler.py scatter_chunk).
// lr/lc: per-row/col path-length normalizers (la + lb divisors built by the
// caller), or NULL for normalize="none".
// Normalize blk[:nr,:nc] into the caller's [nr, nc] scratch (row-major,
// stride nc).  Vectorizable: the divisor row (lr[r] + lc[c]) is built once
// per row and both loops are unit-stride.
static void norm_block(const float* blk, int ti, int nr, int nc,
                       const float* lr, const float* lc, float* tmp) {
  if (!lr) {
    for (int r = 0; r < nr; ++r)
      std::memcpy(tmp + (size_t)r * nc, blk + (size_t)r * ti,
                  sizeof(float) * nc);
    return;
  }
  for (int r = 0; r < nr; ++r) {
    const float* row = blk + (size_t)r * ti;
    float* out = tmp + (size_t)r * nc;
    const float a = lr[r];
    for (int c = 0; c < nc; ++c) out[c] = row[c] / (a + lc[c]);
  }
}

// Cache-blocked transposed write: dst[c * stride + r] = src[r * nc + c].
// 32x32 tiles keep both the read rows and the written column runs inside
// L1 on the shared vCPU.
static void write_transposed(const float* src, int nr, int nc,
                             float* dst, int64_t stride) {
  constexpr int TB = 32;
  for (int cb = 0; cb < nc; cb += TB)
    for (int rb = 0; rb < nr; rb += TB) {
      int ce = std::min(cb + TB, nc), re = std::min(rb + TB, nr);
      for (int c = cb; c < ce; ++c) {
        float* out = dst + (size_t)c * stride;
        for (int r = rb; r < re; ++r) out[r] = src[(size_t)r * nc + c];
      }
    }
}

void apd_scatter_block_direct(const float* blk, int ti, int nr, int nc,
                              const float* lr, const float* lc,
                              const int64_t* pr, const int64_t* pc,
                              float* D, int64_t K, int diag) {
  std::vector<float> tmp((size_t)nr * nc);
  norm_block(blk, ti, nr, nc, lr, lc, tmp.data());
  if (diag) {
    // strict upper mirrored, exact-zero diagonal (nr == nc for diag tiles)
    for (int r = 0; r < nr; ++r) {
      tmp[(size_t)r * nc + r] = 0.0f;
      for (int c = 0; c < r; ++c)
        tmp[(size_t)r * nc + c] = tmp[(size_t)c * nc + r];
    }
  }
  for (int r = 0; r < nr; ++r) {
    const float* row = tmp.data() + (size_t)r * nc;
    float* Dr = D + (size_t)pr[r] * K;
    for (int c = 0; c < nc; ++c) Dr[pc[c]] = row[c];
  }
  for (int c = 0; c < nc; ++c) {
    float* Dc = D + (size_t)pc[c] * K;
    for (int r = 0; r < nr; ++r) Dc[pr[r]] = tmp[(size_t)r * nc + c];
  }
}

// Strip-buffer mode (K too large for fancy-indexed writes; D assembled one
// ti-row strip at a time in SORTED order, un-permuted when a strip
// completes).  Writes the normalized block into strip I at column c0 and its
// transpose into strip J at column r0 in the same pass over blk.  bufJ may
// be NULL (diagonal tiles contribute once, mirrored in-block: strict upper
// + its transpose, zero diagonal).
void apd_scatter_block_strip(const float* blk, int ti, int nr, int nc,
                             const float* lr, const float* lc,
                             float* bufI, int64_t strideI, int64_t c0,
                             float* bufJ, int64_t strideJ, int64_t r0) {
  std::vector<float> tmp((size_t)nr * nc);
  norm_block(blk, ti, nr, nc, lr, lc, tmp.data());
  if (bufJ == nullptr) {
    // diagonal tile: strict upper mirrored in place, exact-zero diagonal
    for (int r = 0; r < nr; ++r) {
      tmp[(size_t)r * nc + r] = 0.0f;
      for (int c = 0; c < r; ++c)
        tmp[(size_t)r * nc + c] = tmp[(size_t)c * nc + r];
    }
    for (int r = 0; r < nr; ++r)
      std::memcpy(bufI + (size_t)r * strideI + c0, tmp.data() + (size_t)r * nc,
                  sizeof(float) * nc);
    return;
  }
  for (int r = 0; r < nr; ++r)
    std::memcpy(bufI + (size_t)r * strideI + c0, tmp.data() + (size_t)r * nc,
                sizeof(float) * nc);
  write_transposed(tmp.data(), nr, nc, bufJ + r0, strideJ);
}

// Strip completion: rows [n_rows, K] of the SORTED-order strip buffer are
// un-permuted into D's original-order rows: D[row_ids[r], :] = buf[r, inv]
// (the NumPy equivalent np.take(buf, inv, axis=1) materializes a second
// strip-sized temp before the row copy; this gathers straight into D).
void apd_strip_unpermute(const float* buf, int n_rows, int64_t K,
                         const int64_t* inv, const int64_t* row_ids,
                         float* D) {
  for (int r = 0; r < n_rows; ++r) {
    const float* src = buf + (size_t)r * K;
    float* dst = D + (size_t)row_ids[r] * K;
    for (int64_t c = 0; c < K; ++c) dst[c] = src[inv[c]];
  }
}

}  // extern "C"
