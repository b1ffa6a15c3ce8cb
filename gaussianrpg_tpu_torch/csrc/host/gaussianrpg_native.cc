// Host data-path runtime of gaussianrpg_tpu_torch (C ABI, loaded with
// ctypes by data/native.py).
//
// A copy of the JAX package's native/gaussianrpg_native.cc: a TFRecord
// record reader equivalent to simple-waymo-open-dataset-reader's python
// framing parser (`simple_waymo_open_dataset_reader/__init__.py:19-92`)
// and a binary-PLY bulk loader. The baseline JPEG decoder of the same
// library is jpeg_decode.cc.
//
// Built by data/native.py with the host compiler
// (c++ -O3 -fPIC -shared -std=c++17) into build/kernels at first use.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Buffer {
  std::vector<uint8_t> data;
};

struct RecordIndex {
  // byte offset + length of each TFRecord payload
  std::vector<uint64_t> offsets;
  std::vector<uint64_t> lengths;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// TFRecord framing: u64 length | u32 masked-crc(length) | payload |
// u32 masked-crc(payload). CRCs are not verified (matching the reference
// python reader, which skips them too).
// ---------------------------------------------------------------------------

void* tfrecord_index_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* idx = new RecordIndex();
  uint64_t pos = 0;
  for (;;) {
    uint64_t len = 0;
    if (std::fread(&len, sizeof(len), 1, f) != 1) break;
    // skip length crc
    if (std::fseek(f, 4, SEEK_CUR) != 0) break;
    uint64_t payload_ofs = pos + 12;
    idx->offsets.push_back(payload_ofs);
    idx->lengths.push_back(len);
    // skip payload + payload crc
    if (std::fseek(f, static_cast<long>(len) + 4, SEEK_CUR) != 0) break;
    pos = payload_ofs + len + 4;
  }
  std::fclose(f);
  return idx;
}

int64_t tfrecord_index_count(void* handle) {
  if (!handle) return -1;
  return static_cast<int64_t>(static_cast<RecordIndex*>(handle)
                                  ->offsets.size());
}

int64_t tfrecord_record_length(void* handle, int64_t i) {
  auto* idx = static_cast<RecordIndex*>(handle);
  if (!idx || i < 0 || i >= static_cast<int64_t>(idx->lengths.size()))
    return -1;
  return static_cast<int64_t>(idx->lengths[i]);
}

// Copies record i's payload into out (caller allocates record_length bytes).
int64_t tfrecord_read_record(void* handle, const char* path, int64_t i,
                             uint8_t* out) {
  auto* idx = static_cast<RecordIndex*>(handle);
  if (!idx || i < 0 || i >= static_cast<int64_t>(idx->offsets.size()))
    return -1;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t n = -1;
  if (std::fseek(f, static_cast<long>(idx->offsets[i]), SEEK_SET) == 0) {
    size_t len = idx->lengths[i];
    if (std::fread(out, 1, len, f) == len) n = static_cast<int64_t>(len);
  }
  std::fclose(f);
  return n;
}

void tfrecord_index_free(void* handle) {
  delete static_cast<RecordIndex*>(handle);
}

// ---------------------------------------------------------------------------
// Binary little-endian PLY bulk loader: parses the header of a single-
// element f32-only PLY (the 3DGS layout) and memcpies the body into a
// caller-provided [count, n_props] f32 buffer. ~memcpy speed for
// multi-million-vertex files.
// ---------------------------------------------------------------------------

// Returns 0 on success; fills *count and *n_props. If out != nullptr it
// must hold count*n_props floats.
int ply_load_f32(const char* path, const char* element_name,
                 int64_t* count, int32_t* n_props, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[4096];
  std::string want = element_name ? element_name : "";
  int64_t cur_count = -1, target_count = -1;
  int32_t cur_props = 0, target_props = 0;
  uint64_t skip_before = 0;  // bytes of earlier elements to skip
  bool in_target = false, found = false, binary_le = false;
  uint64_t cur_row_bytes = 0;
  std::vector<uint64_t> pending_skips;

  // parse header
  for (;;) {
    if (!std::fgets(line, sizeof(line), f)) {
      std::fclose(f);
      return -2;
    }
    std::string s(line);
    if (s.rfind("format", 0) == 0) {
      binary_le = s.find("binary_little_endian") != std::string::npos;
    } else if (s.rfind("element", 0) == 0) {
      // close the previous element
      if (cur_count >= 0 && !in_target)
        skip_before += cur_count * cur_row_bytes;
      char name[512];
      long long n;
      if (std::sscanf(s.c_str(), "element %511s %lld", name, &n) == 2) {
        cur_count = n;
        cur_row_bytes = 0;
        cur_props = 0;
        in_target = (want.empty() && !found) || want == name;
        if (in_target) {
          found = true;
          target_count = n;
        }
      }
    } else if (s.rfind("property", 0) == 0) {
      // only float/f4 supported for the bulk path
      uint64_t sz = s.find(" float ") != std::string::npos ||
                            s.find(" float32 ") != std::string::npos
                        ? 4
                        : 0;
      if (sz == 0) {
        std::fclose(f);
        return -3;
      }
      cur_row_bytes += sz;
      cur_props += 1;
      if (in_target) target_props = cur_props;
    } else if (s.rfind("end_header", 0) == 0) {
      if (cur_count >= 0 && !in_target)
        skip_before += cur_count * cur_row_bytes;
      break;
    }
  }
  if (!binary_le || !found) {
    std::fclose(f);
    return -4;
  }
  *count = target_count;
  *n_props = target_props;
  int rc = 0;
  if (out) {
    if (std::fseek(f, static_cast<long>(skip_before), SEEK_CUR) != 0)
      rc = -5;
    else {
      size_t total = static_cast<size_t>(target_count) * target_props;
      if (std::fread(out, sizeof(float), total, f) != total) rc = -6;
    }
  }
  std::fclose(f);
  return rc;
}

}  // extern "C"
