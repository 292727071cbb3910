// Native batched .npy feature loader: the training input pipeline's host
// path "read B feature files, uniformly resample each to T frames, pack
// into one (B, T, F) float32 batch" done for the whole batch in C++, one
// thread per item, resampled rows read or memcpy'd straight into the
// caller's buffer. A copy of video_captioning_tpu/native/vcload.cc, built
// by video_captioning_tpu_torch/native/__init__.py.
//
// Supported: .npy v1.0/v2.0, dtype '<f4', C-order, shape (T, F).
// Returns 0 on success; (index+1) of the first failing item otherwise.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  long t = 0;
  long f = 0;
  long data_offset = 0;
};

// Parse the npy header; returns false on any unsupported layout.
bool parse_header(std::FILE* fp, NpyInfo* info) {
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, fp) != 8) return false;
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char hl[2];
    if (std::fread(hl, 1, 2, fp) != 2) return false;
    header_len = hl[0] | (hl[1] << 8);
    info->data_offset = 10 + header_len;
  } else if (major == 2 || major == 3) {
    unsigned char hl[4];
    if (std::fread(hl, 1, 4, fp) != 4) return false;
    header_len = hl[0] | (hl[1] << 8) | (hl[2] << 16) |
                 (static_cast<uint32_t>(hl[3]) << 24);
    info->data_offset = 12 + header_len;
  } else {
    return false;
  }

  std::string header(header_len, '\0');
  if (std::fread(&header[0], 1, header_len, fp) != header_len) return false;

  if (header.find("'<f4'") == std::string::npos &&
      header.find("\"<f4\"") == std::string::npos)
    return false;
  if (header.find("'fortran_order': False") == std::string::npos)
    return false;

  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return false;
  size_t open = header.find('(', sp);
  size_t close = header.find(')', open);
  if (open == std::string::npos || close == std::string::npos) return false;
  std::string shape = header.substr(open + 1, close - open - 1);
  long dims[2] = {0, 0};
  int nd = 0;
  const char* s = shape.c_str();
  char* end = nullptr;
  while (nd < 2) {
    long v = std::strtol(s, &end, 10);
    if (end == s) break;
    dims[nd++] = v;
    s = end;
    while (*s == ',' || *s == ' ') ++s;
  }
  if (nd != 2) return false;
  info->t = dims[0];
  info->f = dims[1];
  return true;
}

// Load one file's features resampled/zero-padded to (target_len, feat_dim)
// rows written at `out` (row stride feat_dim floats).
bool load_one(const char* path, float* out, long target_len, long feat_dim) {
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  NpyInfo info;
  if (!parse_header(fp, &info) || info.f != feat_dim || info.t <= 0) {
    std::fclose(fp);
    return false;
  }
  const long row_bytes = feat_dim * static_cast<long>(sizeof(float));

  if (info.t == target_len) {
    bool ok = std::fseek(fp, info.data_offset, SEEK_SET) == 0 &&
              std::fread(out, 1, row_bytes * target_len, fp) ==
                  static_cast<size_t>(row_bytes * target_len);
    std::fclose(fp);
    return ok;
  }

  if (info.t < target_len) {
    // Read everything, zero-pad the tail (dataset.py:142-148 semantics).
    if (std::fseek(fp, info.data_offset, SEEK_SET) != 0 ||
        std::fread(out, 1, row_bytes * info.t, fp) !=
            static_cast<size_t>(row_bytes * info.t)) {
      std::fclose(fp);
      return false;
    }
    std::memset(out + info.t * feat_dim, 0,
                row_bytes * (target_len - info.t));
    std::fclose(fp);
    return true;
  }

  // info.t > target_len: numpy linspace(0, t-1, target) row selection
  // (dataset.py:137-141). One bulk read (sequential IO beats 80 seeks),
  // then memcpy the selected rows. Replicate numpy's exact arithmetic:
  // y = i * step with step = (t-1)/(target-1) and the endpoint forced to
  // t-1, then truncate (np.linspace(..., dtype=int) casts toward zero).
  std::vector<float> buf(static_cast<size_t>(info.t) * feat_dim);
  if (std::fseek(fp, info.data_offset, SEEK_SET) != 0 ||
      std::fread(buf.data(), 1, row_bytes * info.t, fp) !=
          static_cast<size_t>(row_bytes * info.t)) {
    std::fclose(fp);
    return false;
  }
  std::fclose(fp);

  const double step =
      (target_len > 1)
          ? static_cast<double>(info.t - 1) / (target_len - 1)
          : 0.0;
  for (long i = 0; i < target_len; ++i) {
    double pos = (i == target_len - 1)
                     ? static_cast<double>(info.t - 1)
                     : static_cast<double>(i) * step;
    long row = static_cast<long>(pos);
    std::memcpy(out + i * feat_dim, buf.data() + row * feat_dim, row_bytes);
  }
  return true;
}

}  // namespace

extern "C" {

// out: (n, target_len, feat_dim) float32, caller-allocated.
// Returns 0 on success, or 1-based index of the first failed item.
int vc_load_features_batch(const char** paths, int n, float* out,
                           long target_len, long feat_dim) {
  std::vector<int> status(n, 0);
  unsigned hw = std::thread::hardware_concurrency();
  int workers = static_cast<int>(hw ? hw : 4);
  if (workers > n) workers = n;
  std::vector<std::thread> threads;
  threads.reserve(workers);
  std::atomic<int> next{0};
  for (int w = 0; w < workers; ++w) {
    threads.emplace_back([&]() {
      while (true) {
        int i = next.fetch_add(1);
        if (i >= n) break;
        float* dst = out + static_cast<long>(i) * target_len * feat_dim;
        status[i] = load_one(paths[i], dst, target_len, feat_dim) ? 0 : 1;
      }
    });
  }
  for (auto& t : threads) t.join();
  for (int i = 0; i < n; ++i)
    if (status[i]) return i + 1;
  return 0;
}

// Probe a file: fills t/f dims; returns 0 on success.
int vc_probe_npy(const char* path, long* t, long* f) {
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  NpyInfo info;
  bool ok = parse_header(fp, &info);
  std::fclose(fp);
  if (!ok) return 2;
  *t = info.t;
  *f = info.f;
  return 0;
}

}  // extern "C"
