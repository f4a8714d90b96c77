// TFRecord reader and writer for the host: record framing, crc32c and the
// tf.Example subset of the reference's records (raw uint8 bytes under 'x',
// an int64 label under 'y'). The port's own copy of the JAX package's
// native/tfrec.cc, with its C interface: tfrec_open, tfrec_read_batch,
// tfrec_close, tfrec_writer_open, tfrec_write_batch, tfrec_writer_close,
// tfrec_crc32c and tfrec_masked_crc32c, bound by ctypes in
// mmdgan_torch/data/native.py. It runs on the host, not on the card: g++
// builds it (mmdgan_torch/ops/_build.py).
//
// The input pipeline's hot path (input_func.py:721-965) reads record
// frames, parses the tf.Example protobuf and copies the raw image bytes
// into a batch buffer. Python does that a record at a time; this fills a
// caller's batch buffers in one call with buffered IO and a scan
// specialised to the schema.
//
// Wire formats:
//   TFRecord frame: u64le length | u32le masked-crc32c(length) |
//                   payload | u32le masked-crc32c(payload)
//   tf.Example subset: Example.features(1) > map entry(1) with
//     key(1)=string, value(2)=Feature; Feature: bytes_list(1) |
//     float_list(2) | int64_list(3); lists: value(1) packed or repeated.
//
// CRC verification is optional (off by default, as in tf.data).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// crc32c (Castagnoli) — slice-by-8 table implementation
// ---------------------------------------------------------------------
uint32_t g_crc_table[8][256];
bool g_crc_init = false;

void crc_init() {
  if (g_crc_init) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int k = 0; k < 8; k++) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    g_crc_table[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = g_crc_table[0][i];
    for (int s = 1; s < 8; s++) {
      crc = (crc >> 8) ^ g_crc_table[0][crc & 0xFF];
      g_crc_table[s][i] = crc;
    }
  }
  g_crc_init = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  crc_init();
  uint32_t crc = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t word;
    memcpy(&word, data, 8);
    word ^= crc;
    crc = g_crc_table[7][word & 0xFF] ^ g_crc_table[6][(word >> 8) & 0xFF] ^
          g_crc_table[5][(word >> 16) & 0xFF] ^
          g_crc_table[4][(word >> 24) & 0xFF] ^
          g_crc_table[3][(word >> 32) & 0xFF] ^
          g_crc_table[2][(word >> 40) & 0xFF] ^
          g_crc_table[1][(word >> 48) & 0xFF] ^
          g_crc_table[0][(word >> 56) & 0xFF];
    data += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ g_crc_table[0][(crc ^ *data++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------
// varint / proto scanning
// ---------------------------------------------------------------------
inline bool read_varint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    result |= uint64_t(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

inline bool skip_field(const uint8_t*& p, const uint8_t* end, uint32_t wire) {
  uint64_t tmp;
  switch (wire) {
    case 0:
      return read_varint(p, end, &tmp);
    case 1:
      if (end - p < 8) return false;
      p += 8;
      return true;
    case 2:
      if (!read_varint(p, end, &tmp) || uint64_t(end - p) < tmp) return false;
      p += tmp;
      return true;
    case 5:
      if (end - p < 4) return false;
      p += 4;
      return true;
    default:
      return false;
  }
}

struct ExampleView {
  const uint8_t* x_data = nullptr;
  size_t x_len = 0;
  int64_t y = 0;
  bool has_x = false;
  bool has_y = false;
};

// Parse Feature message, returning bytes view or first int64.
bool parse_feature(const uint8_t* p, const uint8_t* end, ExampleView* ex,
                   bool is_x) {
  uint64_t tag, len;
  while (p < end) {
    if (!read_varint(p, end, &tag)) return false;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (wire != 2) {
      if (!skip_field(p, end, wire)) return false;
      continue;
    }
    if (!read_varint(p, end, &len) || uint64_t(end - p) < len) return false;
    const uint8_t* body = p;
    const uint8_t* bend = p + len;
    p += len;
    if (field == 1 && is_x) {  // BytesList
      uint64_t t2, l2;
      const uint8_t* q = body;
      while (q < bend) {
        if (!read_varint(q, bend, &t2)) return false;
        if ((t2 & 7) != 2) {
          if (!skip_field(q, bend, t2 & 7)) return false;
          continue;
        }
        if (!read_varint(q, bend, &l2) || uint64_t(bend - q) < l2) return false;
        ex->x_data = q;
        ex->x_len = l2;
        ex->has_x = true;
        return true;
      }
    } else if (field == 3 && !is_x) {  // Int64List
      uint64_t t2, l2, v;
      const uint8_t* q = body;
      while (q < bend) {
        if (!read_varint(q, bend, &t2)) return false;
        uint32_t w2 = t2 & 7;
        if (w2 == 2) {  // packed
          if (!read_varint(q, bend, &l2) || uint64_t(bend - q) < l2)
            return false;
          const uint8_t* r = q;
          if (read_varint(r, q + l2, &v)) {
            ex->y = int64_t(v);
            ex->has_y = true;
          }
          return true;
        } else if (w2 == 0) {
          if (!read_varint(q, bend, &v)) return false;
          ex->y = int64_t(v);
          ex->has_y = true;
          return true;
        } else {
          if (!skip_field(q, bend, w2)) return false;
        }
      }
    }
  }
  return true;
}

// Scan a serialized tf.Example for 'x' (bytes) and 'y' (int64).
bool parse_example(const uint8_t* p, const uint8_t* end, ExampleView* ex) {
  uint64_t tag, len;
  while (p < end) {
    if (!read_varint(p, end, &tag)) return false;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 2) {  // Example.features
      if (!read_varint(p, end, &len) || uint64_t(end - p) < len) return false;
      const uint8_t* fend = p + len;
      // Features: repeated map entries (field 1)
      while (p < fend) {
        uint64_t etag, elen;
        if (!read_varint(p, fend, &etag)) return false;
        if ((etag >> 3) != 1 || (etag & 7) != 2) {
          if (!skip_field(p, fend, etag & 7)) return false;
          continue;
        }
        if (!read_varint(p, fend, &elen) || uint64_t(fend - p) < elen)
          return false;
        const uint8_t* eend = p + elen;
        // map entry: key(1)=string, value(2)=Feature
        const uint8_t* kp = nullptr;
        size_t klen = 0;
        const uint8_t* vp = nullptr;
        size_t vlen = 0;
        while (p < eend) {
          uint64_t mtag, mlen;
          if (!read_varint(p, eend, &mtag)) return false;
          if ((mtag & 7) != 2) {
            if (!skip_field(p, eend, mtag & 7)) return false;
            continue;
          }
          if (!read_varint(p, eend, &mlen) || uint64_t(eend - p) < mlen)
            return false;
          if ((mtag >> 3) == 1) {
            kp = p;
            klen = mlen;
          } else if ((mtag >> 3) == 2) {
            vp = p;
            vlen = mlen;
          }
          p += mlen;
        }
        if (kp && vp) {
          if (klen == 1 && kp[0] == 'x') {
            if (!parse_feature(vp, vp + vlen, ex, /*is_x=*/true)) return false;
          } else if (klen == 1 && kp[0] == 'y') {
            if (!parse_feature(vp, vp + vlen, ex, /*is_x=*/false)) return false;
          }
        }
      }
    } else {
      if (!skip_field(p, end, wire)) return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------
// reader state
// ---------------------------------------------------------------------
struct Reader {
  FILE* f = nullptr;
  std::vector<uint8_t> buf;
  bool verify_crc = false;
  std::string error;
};

// ---------------------------------------------------------------------
// writer: mirror of the Python TFRecordWriter/make_example encoding
// (mmdgan_torch/data/tfrecord.py) — byte-identical output, feature order
// 'x' then 'y', Int64List packed varints.
// ---------------------------------------------------------------------
struct Writer {
  FILE* f = nullptr;
  std::vector<uint8_t> rec;
};

void put_varint(std::vector<uint8_t>& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back(uint8_t(v) | 0x80);
    v >>= 7;
  }
  out.push_back(uint8_t(v));
}

void put_len_delim(std::vector<uint8_t>& out, uint32_t field,
                   const uint8_t* p, size_t n) {
  put_varint(out, (field << 3) | 2);
  put_varint(out, n);
  if (n) out.insert(out.end(), p, p + n);
}

void build_example(std::vector<uint8_t>& rec, const uint8_t* x, size_t xlen,
                   const int64_t* y) {
  std::vector<uint8_t> bl, feat, entry, feats;
  // Feature 'x': Feature.bytes_list(1) > BytesList.value(1)
  put_len_delim(bl, 1, x, xlen);
  put_len_delim(feat, 1, bl.data(), bl.size());
  const uint8_t kx = 'x';
  put_len_delim(entry, 1, &kx, 1);
  put_len_delim(entry, 2, feat.data(), feat.size());
  put_len_delim(feats, 1, entry.data(), entry.size());
  if (y) {
    // Feature 'y': Feature.int64_list(3) > Int64List.value(1) packed
    std::vector<uint8_t> body, il, feat_y, entry_y;
    put_varint(body, uint64_t(*y));
    put_varint(il, (1u << 3) | 2);
    put_varint(il, body.size());
    il.insert(il.end(), body.begin(), body.end());
    put_len_delim(feat_y, 3, il.data(), il.size());
    const uint8_t ky = 'y';
    put_len_delim(entry_y, 1, &ky, 1);
    put_len_delim(entry_y, 2, feat_y.data(), feat_y.size());
    put_len_delim(feats, 1, entry_y.data(), entry_y.size());
  }
  rec.clear();
  put_len_delim(rec, 1, feats.data(), feats.size());
}

}  // namespace

extern "C" {

void* tfrec_open(const char* path, int verify_crc) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  setvbuf(f, nullptr, _IOFBF, 1 << 20);
  Reader* r = new Reader();
  r->f = f;
  r->verify_crc = verify_crc != 0;
  return r;
}

void tfrec_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (r) {
    if (r->f) fclose(r->f);
    delete r;
  }
}

// Read up to `batch` examples. For each example i:
//   copy min(x_len, x_capacity) bytes of x into x_buf + i*x_capacity,
//   store x length into x_lens[i], label into y_buf[i] (if non-null).
// Returns number of examples read (0 = EOF), -1 on parse error.
int tfrec_read_batch(void* handle, uint8_t* x_buf, int64_t x_capacity,
                     int64_t* x_lens, int32_t* y_buf, int batch) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r || !r->f) return -1;
  int count = 0;
  while (count < batch) {
    uint8_t header[8];
    size_t got = fread(header, 1, 8, r->f);
    if (got == 0) break;  // EOF
    if (got < 8) return -1;
    uint64_t len;
    memcpy(&len, header, 8);
    uint8_t crc_h[4];
    if (fread(crc_h, 1, 4, r->f) != 4) return -1;
    if (r->verify_crc) {
      uint32_t expect;
      memcpy(&expect, crc_h, 4);
      if (masked_crc32c(header, 8) != expect) return -1;
    }
    if (len > (1ull << 31)) return -1;
    r->buf.resize(len);
    if (len && fread(r->buf.data(), 1, len, r->f) != len) return -1;
    uint8_t crc_p[4];
    if (fread(crc_p, 1, 4, r->f) != 4) return -1;
    if (r->verify_crc) {
      uint32_t expect;
      memcpy(&expect, crc_p, 4);
      if (masked_crc32c(r->buf.data(), len) != expect) return -1;
    }
    ExampleView ex;
    if (!parse_example(r->buf.data(), r->buf.data() + len, &ex)) return -1;
    if (!ex.has_x) return -1;
    int64_t n = int64_t(ex.x_len) < x_capacity ? int64_t(ex.x_len) : x_capacity;
    memcpy(x_buf + int64_t(count) * x_capacity, ex.x_data, size_t(n));
    if (x_lens) x_lens[count] = int64_t(ex.x_len);
    if (y_buf) y_buf[count] = ex.has_y ? int32_t(ex.y) : -1;
    count++;
  }
  return count;
}

// ---------------------------------------------------------------------
// bulk writer
// ---------------------------------------------------------------------

void* tfrec_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  setvbuf(f, nullptr, _IOFBF, 1 << 20);
  Writer* w = new Writer();
  w->f = f;
  return w;
}

// Write n examples; example i gets feature 'x' = x + i*bytes_per_record
// (bytes_per_record raw uint8 bytes) and, if y != nullptr, 'y' = y[i].
// Returns n on success, -1 on IO error.
int64_t tfrec_write_batch(void* handle, const uint8_t* x,
                          int64_t bytes_per_record, int64_t n,
                          const int64_t* y) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w || !w->f) return -1;
  for (int64_t i = 0; i < n; i++) {
    build_example(w->rec, x + i * bytes_per_record, size_t(bytes_per_record),
                  y ? &y[i] : nullptr);
    uint8_t header[8];
    uint64_t len = w->rec.size();
    memcpy(header, &len, 8);
    uint32_t crc_h = masked_crc32c(header, 8);
    uint32_t crc_p = masked_crc32c(w->rec.data(), w->rec.size());
    if (fwrite(header, 1, 8, w->f) != 8) return -1;
    if (fwrite(&crc_h, 1, 4, w->f) != 4) return -1;
    if (w->rec.size() &&
        fwrite(w->rec.data(), 1, w->rec.size(), w->f) != w->rec.size())
      return -1;
    if (fwrite(&crc_p, 1, 4, w->f) != 4) return -1;
  }
  return n;
}

// Returns 0 on clean close, -1 on flush/close error.
int tfrec_writer_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w) return -1;
  int rc = 0;
  if (w->f && fclose(w->f) != 0) rc = -1;
  delete w;
  return rc;
}

// Convenience: crc32c of a buffer (used by tests).
uint32_t tfrec_crc32c(const uint8_t* data, int64_t n) {
  return crc32c(data, size_t(n));
}

uint32_t tfrec_masked_crc32c(const uint8_t* data, int64_t n) {
  return masked_crc32c(data, size_t(n));
}

}  // extern "C"
