// Native host runtime for urban_road_filter_torch: a copy of the JAX
// package's runtime/csrc/urf_native.cpp, built into the port's own cache.
//
// The reference's native surface is its C++ ROS node + PCL ingest
// (SURVEY.md section 2, C2-C3).  The TPU rebuild keeps the *compute* in
// XLA; this library is the host-side native equivalent of the ingest/IO
// layer: a fast binary/ascii PCD parser and a multithreaded batch stager
// that packs scans into the padded (N, 4) float32 layout the device
// expects.  Exposed through a plain C ABI for ctypes (no pybind11 in the
// image).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread
//        urf_native.cpp -o liburf_native.so

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Field {
  std::string name;
  int size = 4;
  char type = 'F';
  int count = 1;
};

struct PcdHeader {
  std::vector<Field> fields;
  long points = 0;
  std::string data;  // "ascii" | "binary" | "binary_compressed"
  long header_end = 0;
  int point_stride = 0;
};

bool parse_header(FILE* f, PcdHeader* h) {
  char line[4096];
  std::vector<std::string> names, sizes, types, counts;
  while (fgets(line, sizeof line, f)) {
    std::string s(line);
    if (s.empty() || s[0] == '#') continue;
    // tokenize
    std::vector<std::string> tok;
    size_t i = 0;
    while (i < s.size()) {
      while (i < s.size() && std::isspace((unsigned char)s[i])) i++;
      size_t j = i;
      while (j < s.size() && !std::isspace((unsigned char)s[j])) j++;
      if (j > i) tok.push_back(s.substr(i, j - i));
      i = j;
    }
    if (tok.empty()) continue;
    const std::string& key = tok[0];
    if (key == "FIELDS") names.assign(tok.begin() + 1, tok.end());
    else if (key == "SIZE") sizes.assign(tok.begin() + 1, tok.end());
    else if (key == "TYPE") types.assign(tok.begin() + 1, tok.end());
    else if (key == "COUNT") counts.assign(tok.begin() + 1, tok.end());
    else if (key == "POINTS" && tok.size() > 1) h->points = atol(tok[1].c_str());
    else if (key == "WIDTH" && tok.size() > 1 && h->points == 0)
      h->points = atol(tok[1].c_str());
    else if (key == "HEIGHT" && tok.size() > 1 && h->points > 0) {
      // points may be width*height; PCD writes POINTS explicitly, but be safe
    } else if (key == "DATA" && tok.size() > 1) {
      h->data = tok[1];
      h->header_end = ftell(f);
      break;
    }
  }
  if (h->data.empty() || names.empty()) return false;
  for (size_t k = 0; k < names.size(); k++) {
    Field fd;
    fd.name = names[k];
    fd.size = k < sizes.size() ? atoi(sizes[k].c_str()) : 4;
    fd.type = k < types.size() && !types[k].empty() ? types[k][0] : 'F';
    fd.count = k < counts.size() ? atoi(counts[k].c_str()) : 1;
    h->fields.push_back(fd);
    h->point_stride += fd.size * fd.count;
  }
  return true;
}

// liblzf stream decoder (PCL binary_compressed payloads; same control-byte
// scheme as io/pcd.py lzf_decompress, fuzz-tested against it): ctrl < 32 is
// a literal run of ctrl+1 bytes; otherwise a back-reference of (ctrl>>5)+2
// bytes (+1 extension byte when saturated at 7) at distance
// ((ctrl & 0x1f) << 8) + next + 1.  Returns bytes written or -1 on a
// malformed stream (overrun, dangling reference, size mismatch).
long lzf_decompress(const unsigned char* in, long in_len, unsigned char* out,
                    long out_len) {
  long i = 0, o = 0;
  while (i < in_len) {
    unsigned ctrl = in[i++];
    if (ctrl < 32) {
      long run = (long)ctrl + 1;
      if (i + run > in_len || o + run > out_len) return -1;
      std::memcpy(out + o, in + i, (size_t)run);
      i += run;
      o += run;
    } else {
      long len = (long)(ctrl >> 5);
      if (len == 7) {
        if (i >= in_len) return -1;
        len += in[i++];
      }
      len += 2;
      if (i >= in_len) return -1;
      long ref = o - (((long)(ctrl & 0x1F) << 8) + in[i++] + 1);
      if (ref < 0 || o + len > out_len) return -1;
      // References may overlap their output (RLE-style); copy forward
      // byte-wise only in that case, else one memcpy.
      if (o - ref >= len) {
        std::memcpy(out + o, out + ref, (size_t)len);
        o += len;
      } else {
        for (long k = 0; k < len; k++) out[o++] = out[ref++];
      }
    }
  }
  return o == out_len ? o : -1;
}

float field_as_float(const unsigned char* p, const Field& f) {
  if (f.type == 'F' && f.size == 4) { float v; std::memcpy(&v, p, 4); return v; }
  if (f.type == 'F' && f.size == 8) { double v; std::memcpy(&v, p, 8); return (float)v; }
  if (f.type == 'U' && f.size == 1) return (float)*p;
  if (f.type == 'U' && f.size == 2) { uint16_t v; std::memcpy(&v, p, 2); return (float)v; }
  if (f.type == 'U' && f.size == 4) { uint32_t v; std::memcpy(&v, p, 4); return (float)v; }
  if (f.type == 'I' && f.size == 1) return (float)(int8_t)*p;
  if (f.type == 'I' && f.size == 2) { int16_t v; std::memcpy(&v, p, 2); return (float)v; }
  if (f.type == 'I' && f.size == 4) { int32_t v; std::memcpy(&v, p, 4); return (float)v; }
  return 0.0f;
}

}  // namespace

extern "C" {

// Parse a PCD file into out[(capacity, 4)] float32 rows (x, y, z, intensity).
// Returns number of points written, or a negative error:
//   -1 open failed, -2 bad header, -3 unsupported DATA kind, -4 short read.
long urf_read_pcd(const char* path, float* out, long capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  PcdHeader h;
  if (!parse_header(f, &h)) { fclose(f); return -2; }
  // Never trust the header (a corrupt/hostile POINTS value must not drive
  // an unchecked allocation): require a positive count and stride, and for
  // binary data require points*stride to fit in the bytes actually present
  // after the header.
  if (h.points <= 0 || h.point_stride <= 0) { fclose(f); return -2; }
  if (h.data == "binary") {
    if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -2; }
    long file_end = ftell(f);
    if (file_end < 0 || fseek(f, h.header_end, SEEK_SET) != 0) {
      fclose(f);
      return -2;
    }
    long remaining = file_end - h.header_end;
    if (remaining < 0 || h.points > remaining / h.point_stride) {
      fclose(f);
      return -2;
    }
  }

  int off_x = -1, off_y = -1, off_z = -1, off_i = -1;
  int fx = -1, fy = -1, fz = -1, fi = -1;
  {
    int off = 0;
    for (size_t k = 0; k < h.fields.size(); k++) {
      const Field& fd = h.fields[k];
      if (fd.name == "x") { off_x = off; fx = (int)k; }
      else if (fd.name == "y") { off_y = off; fy = (int)k; }
      else if (fd.name == "z") { off_z = off; fz = (int)k; }
      else if (off_i < 0 && (fd.name == "intensity" || fd.name == "i" ||
                             fd.name == "reflectivity")) { off_i = off; fi = (int)k; }
      off += fd.size * fd.count;
    }
  }

  long n = h.points < capacity ? h.points : capacity;

  if (h.data == "binary") {
    std::vector<unsigned char> buf((size_t)h.points * h.point_stride);
    size_t got = fread(buf.data(), 1, buf.size(), f);
    fclose(f);
    if (got < (size_t)n * h.point_stride) return -4;
    const bool fast = off_x >= 0 && off_y == off_x + 4 && off_z == off_x + 8 &&
                      fx >= 0 && h.fields[fx].type == 'F' && h.fields[fx].size == 4;
    const int stride = h.point_stride;
    long nthreads = (long)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    auto work = [&](long lo, long hi) {
      for (long p = lo; p < hi; p++) {
        const unsigned char* rec = buf.data() + (size_t)p * stride;
        float* o = out + p * 4;
        if (fast) {
          std::memcpy(o, rec + off_x, 12);
        } else {
          o[0] = fx >= 0 ? field_as_float(rec + off_x, h.fields[fx]) : 0.0f;
          o[1] = fy >= 0 ? field_as_float(rec + off_y, h.fields[fy]) : 0.0f;
          o[2] = fz >= 0 ? field_as_float(rec + off_z, h.fields[fz]) : 0.0f;
        }
        o[3] = fi >= 0 ? field_as_float(rec + off_i, h.fields[fi]) : 0.0f;
      }
    };
    if (n > 65536 && nthreads > 1) {
      std::vector<std::thread> ts;
      long chunk = (n + nthreads - 1) / nthreads;
      for (long t = 0; t < nthreads; t++) {
        long lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        ts.emplace_back(work, lo, hi);
      }
      for (auto& t : ts) t.join();
    } else {
      work(0, n);
    }
    return n;
  }

  if (h.data == "ascii") {
    long written = 0;
    std::vector<double> vals;
    vals.reserve(h.fields.size() * 4);
    char line[16384];
    while (written < n && fgets(line, sizeof line, f)) {
      char* p = line;
      vals.clear();
      while (*p) {
        char* end = nullptr;
        double v = strtod(p, &end);
        if (end == p) break;
        vals.push_back(v);
        p = end;
      }
      if (vals.empty()) continue;
      float* o = out + written * 4;
      long col = 0;
      o[0] = o[1] = o[2] = o[3] = 0.0f;
      for (size_t k = 0; k < h.fields.size(); k++) {
        if (col >= (long)vals.size()) break;
        if ((int)k == fx) o[0] = (float)vals[col];
        else if ((int)k == fy) o[1] = (float)vals[col];
        else if ((int)k == fz) o[2] = (float)vals[col];
        else if ((int)k == fi) o[3] = (float)vals[col];
        col += h.fields[k].count;
      }
      written++;
    }
    fclose(f);
    return written;
  }

  if (h.data == "binary_compressed") {
    // PCL layout: u32 compressed size, u32 uncompressed size, LZF blob of
    // the cloud in structure-of-arrays order (each field's block is
    // size*count*points bytes) — PCL's DEFAULT save format, so this is the
    // hot real-data path (the Python codec is a per-byte loop).
    unsigned char szs[8];
    if (fread(szs, 1, 8, f) != 8) { fclose(f); return -4; }
    uint32_t comp_n, raw_n;
    std::memcpy(&comp_n, szs, 4);
    std::memcpy(&raw_n, szs + 4, 4);
    // Bound both sizes by what SoA layout implies; never trust the header.
    if ((long)raw_n < h.points * (long)h.point_stride) { fclose(f); return -2; }
    std::vector<unsigned char> comp(comp_n);
    if (fread(comp.data(), 1, comp_n, f) != comp_n) { fclose(f); return -4; }
    fclose(f);
    std::vector<unsigned char> raw(raw_n);
    if (lzf_decompress(comp.data(), (long)comp_n, raw.data(), (long)raw_n) < 0)
      return -2;

    // SoA block offsets per field.
    long foff_x = -1, foff_y = -1, foff_z = -1, foff_i = -1;
    {
      long off = 0;
      for (size_t k = 0; k < h.fields.size(); k++) {
        const Field& fd = h.fields[k];
        if ((int)k == fx) foff_x = off;
        else if ((int)k == fy) foff_y = off;
        else if ((int)k == fz) foff_z = off;
        else if ((int)k == fi) foff_i = off;
        off += (long)fd.size * fd.count * h.points;
      }
    }
    // Within a field's SoA block, point p's value starts at
    // p * size * count (multi-count fields store their components
    // per point; x/y/z/intensity use the first component).
    auto copy_col = [&](long foff, int fidx, int col) {
      if (foff < 0) {
        for (long p = 0; p < n; p++) out[p * 4 + col] = 0.0f;
        return;
      }
      const Field& fd = h.fields[fidx];
      const long stride = (long)fd.size * fd.count;
      const unsigned char* base = raw.data() + foff;
      if (fd.type == 'F' && fd.size == 4) {  // the common case: one memcpy
        for (long p = 0; p < n; p++)
          std::memcpy(&out[p * 4 + col], base + p * stride, 4);
      } else {
        for (long p = 0; p < n; p++)
          out[p * 4 + col] = field_as_float(base + p * stride, fd);
      }
    };
    copy_col(foff_x, fx, 0);
    copy_col(foff_y, fy, 1);
    copy_col(foff_z, fz, 2);
    copy_col(foff_i, fi, 3);
    return n;
  }

  fclose(f);
  return -3;  // unknown DATA kind
}

// Standalone LZF decode for fuzz tests against the Python codec.
// Returns bytes written or -1 on malformed input.
long urf_lzf_decompress(const unsigned char* in, long in_len,
                        unsigned char* out, long out_len) {
  return lzf_decompress(in, in_len, out, out_len);
}

// Stage a batch: copy (and zero-pad) B variable-length scans into a
// (B, cap, 4) float32 buffer, multithreaded across scans.
// lens[b] = points in scans[b]; each scans[b] is (lens[b], 4) float32.
void urf_stage_batch(const float** scans, const long* lens, long b,
                     float* out, long cap) {
  long nthreads = (long)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (nthreads > b) nthreads = b;
  if (nthreads > 16) nthreads = 16;
  std::atomic<long> next(0);
  auto work = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= b) return;
      float* dst = out + i * cap * 4;
      long n = lens[i] < cap ? lens[i] : cap;
      std::memcpy(dst, scans[i], (size_t)n * 16);
      std::memset(dst + n * 4, 0, (size_t)(cap - n) * 16);
    }
  };
  std::vector<std::thread> ts;
  for (long t = 0; t < nthreads; t++) ts.emplace_back(work);
  for (auto& t : ts) t.join();
}

// ABI sanity marker (2: + binary_compressed parse, urf_lzf_decompress).
long urf_native_abi_version() { return 2; }

}  // extern "C"
