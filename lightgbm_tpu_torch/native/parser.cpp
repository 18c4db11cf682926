// Fast text parsers for dataset ingestion: CSV/TSV and LibSVM.
//
// Native analog of the reference's parser layer (ref: src/io/parser.cpp
// CSVParser/TSVParser/LibSVMParser + utils/text_reader.h chunked reads) —
// an original implementation exposed through a minimal C ABI consumed via
// ctypes (no pybind11 in this image).
//
// Contract (all functions return 0 on success, negative on error):
//   lgbt_scan(path, &sep, &n_rows, &n_cols, &is_libsvm, &has_header)
//       one streaming pass: sniffs the separator (',', '\t', ' '),
//       LibSVM-ness ("idx:val" tokens), a non-numeric header line, and
//       counts rows and columns (LibSVM: max feature index + 1).
//   lgbt_parse_dense(path, sep, skip_header, out, n_rows, n_cols)
//       fills a row-major float32 [n_rows, n_cols] buffer; empty fields
//       and "na"/"nan"/"null" become NaN.
//   lgbt_parse_libsvm(path, out, label_out, n_rows, n_cols)
//       fills zeros + sparse values; column 0 of the file is the label.
//   lgbt_parse_dense_range / lgbt_parse_libsvm_range
//       chunked resumable variants (ref: utils/text_reader.h
//       ReadPartAndParse): parse up to max_rows data rows starting at a
//       byte offset, reporting rows parsed and the offset after the last
//       consumed line, so a caller can stream a file in bounded chunks
//       through EXACTLY the same field parser as the monolithic entry
//       points (bit-identical values by construction).
//
// Build: g++ -O3 -shared -fPIC parser.cpp -o libparser.so   (see loader.py)

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Buffered line reader (64 KB chunks, handles \r\n and missing trailing \n).
// Tracks the byte offset of the NEXT unconsumed character so the chunked
// range parsers can resume exactly where a previous call stopped.
class LineReader {
 public:
  explicit LineReader(FILE* f, int64_t base = 0)
      : f_(f), pos_(0), len_(0), eof_(false), base_(base) {}

  bool next(std::string* line) {
    line->clear();
    for (;;) {
      if (pos_ >= len_) {
        if (eof_) return !line->empty();
        base_ += static_cast<int64_t>(len_);
        len_ = fread(buf_, 1, sizeof(buf_), f_);
        pos_ = 0;
        if (len_ == 0) {
          eof_ = true;
          return !line->empty();
        }
      }
      char* nl = static_cast<char*>(
          memchr(buf_ + pos_, '\n', len_ - pos_));
      if (nl == nullptr) {
        line->append(buf_ + pos_, len_ - pos_);
        pos_ = len_;
        continue;
      }
      size_t n = nl - (buf_ + pos_);
      line->append(buf_ + pos_, n);
      pos_ += n + 1;
      if (!line->empty() && line->back() == '\r') line->pop_back();
      return true;
    }
  }

  int64_t offset() const { return base_ + static_cast<int64_t>(pos_); }

 private:
  FILE* f_;
  char buf_[1 << 16];
  size_t pos_, len_;
  bool eof_;
  int64_t base_;
};

inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t') ++p;
  return p;
}

inline bool parse_float(const char* s, const char* end, float* out) {
  while (s < end && (*s == ' ')) ++s;
  if (s >= end) {
    *out = NAN;
    return true;
  }
  // common missing markers
  size_t n = end - s;
  if ((n == 2 && strncasecmp(s, "na", 2) == 0) ||
      (n == 3 && strncasecmp(s, "nan", 3) == 0) ||
      (n == 4 && (strncasecmp(s, "null", 4) == 0 ||
                  strncasecmp(s, "none", 4) == 0))) {
    *out = NAN;
    return true;
  }
  char* e = nullptr;
  std::string tmp(s, end);  // strtod needs NUL termination
  double v = strtod(tmp.c_str(), &e);
  if (e == tmp.c_str()) return false;
  *out = static_cast<float>(v);
  return true;
}

bool looks_numeric(const char* s, const char* end) {
  float v;
  return parse_float(s, end, &v);
}

int count_fields(const std::string& line, char sep) {
  int n = 1;
  for (char c : line)
    if (c == sep) ++n;
  return n;
}

bool is_libsvm_token(const char* s, const char* end) {
  const char* colon = static_cast<const char*>(memchr(s, ':', end - s));
  if (colon == nullptr || colon == s) return false;
  for (const char* p = s; p < colon; ++p)
    if (!isdigit(static_cast<unsigned char>(*p))) return false;
  return true;
}

// The ONE dense row parser: the monolithic and range entry points both
// route here, so chunked ingest cannot drift from whole-file parsing.
inline void parse_dense_line(const std::string& line, char sep,
                             float* dst, int64_t n_cols) {
  const char* q = line.c_str();
  const char* endl = q + line.size();
  int64_t col = 0;
  while (q <= endl && col < n_cols) {
    const char* e = static_cast<const char*>(memchr(q, sep, endl - q));
    if (e == nullptr) e = endl;
    if (!parse_float(q, e, &dst[col])) dst[col] = NAN;
    ++col;
    q = e + 1;
  }
  for (; col < n_cols; ++col) dst[col] = NAN;  // ragged line
}

// The ONE LibSVM row parser (dst must be pre-zeroed).
inline void parse_libsvm_line(const std::string& line, float* dst,
                              int64_t n_feat, float* label_out) {
  const char* q = skip_ws(line.c_str());
  const char* endl = line.c_str() + line.size();
  const char* e = q;
  while (e < endl && *e != ' ' && *e != '\t') ++e;
  float lab = 0.0f;
  parse_float(q, e, &lab);
  *label_out = lab;
  q = skip_ws(e);
  while (q < endl) {
    const char* colon = static_cast<const char*>(
        memchr(q, ':', endl - q));
    if (colon == nullptr) break;
    const char* ve = colon + 1;
    while (ve < endl && *ve != ' ' && *ve != '\t') ++ve;
    int64_t idx = strtoll(std::string(q, colon).c_str(), nullptr, 10);
    float v = 0.0f;
    parse_float(colon + 1, ve, &v);
    if (idx >= 0 && idx < n_feat) dst[idx] = v;
    q = skip_ws(ve);
  }
}

}  // namespace

extern "C" {

int lgbt_scan(const char* path, char* sep_out, int64_t* n_rows,
              int64_t* n_cols, int* is_libsvm, int* has_header) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return -1;
  LineReader r(f);
  std::string line;
  int64_t rows = 0;
  int64_t maxcol = 0;
  char sep = ',';
  int libsvm = 0;
  int header = 0;
  bool first = true;
  while (r.next(&line)) {
    if (line.empty() || line[0] == '#') continue;
    if (first) {
      // separator sniff: prefer tab, then comma, then space
      int nt = count_fields(line, '\t');
      int nc = count_fields(line, ',');
      if (nt > 1) sep = '\t';
      else if (nc > 1) sep = ',';
      else sep = ' ';
      // LibSVM sniff: second whitespace token shaped like idx:val
      const char* p = skip_ws(line.c_str());
      const char* sp = p;
      while (*sp && *sp != ' ' && *sp != '\t') ++sp;
      const char* tok2 = skip_ws(sp);
      const char* tok2e = tok2;
      while (*tok2e && *tok2e != ' ' && *tok2e != '\t') ++tok2e;
      if (tok2 < tok2e && is_libsvm_token(tok2, tok2e)) {
        libsvm = 1;
        sep = ' ';
      }
      if (!libsvm) {
        // header sniff: any non-numeric field in the first line
        const char* q = line.c_str();
        const char* endl = q + line.size();
        while (q <= endl) {
          const char* e = static_cast<const char*>(
              memchr(q, sep, endl - q));
          if (e == nullptr) e = endl;
          if (q < e && !looks_numeric(q, e)) {
            header = 1;
            break;
          }
          q = e + 1;
        }
      }
      first = false;
      if (header) continue;  // header line is not a data row
    }
    ++rows;
    if (libsvm) {
      const char* q = line.c_str();
      const char* endl = q + line.size();
      while (q < endl) {
        const char* colon = static_cast<const char*>(
            memchr(q, ':', endl - q));
        if (colon == nullptr) break;
        // walk back to the token start
        const char* ts = colon;
        while (ts > q && isdigit(static_cast<unsigned char>(ts[-1]))) --ts;
        if (ts < colon) {
          int64_t idx = strtoll(std::string(ts, colon).c_str(), nullptr,
                                10);
          if (idx + 1 > maxcol) maxcol = idx + 1;
        }
        q = colon + 1;
      }
    } else {
      int nf = count_fields(line, sep);
      if (nf > maxcol) maxcol = nf;
    }
  }
  fclose(f);
  *sep_out = sep;
  *n_rows = rows;
  *n_cols = libsvm ? maxcol + 1 : maxcol;  // +1: label column 0
  *is_libsvm = libsvm;
  *has_header = header;
  return 0;
}

int lgbt_parse_dense(const char* path, char sep, int skip_header,
                     float* out, int64_t n_rows, int64_t n_cols) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return -1;
  LineReader r(f);
  std::string line;
  int64_t row = 0;
  bool first = true;
  while (r.next(&line) && row < n_rows) {
    if (line.empty() || line[0] == '#') continue;
    if (first && skip_header) {
      first = false;
      continue;
    }
    first = false;
    parse_dense_line(line, sep, out + row * n_cols, n_cols);
    ++row;
  }
  fclose(f);
  return row == n_rows ? 0 : -2;
}

int lgbt_parse_dense_range(const char* path, char sep, int skip_header,
                           int64_t offset, float* out, int64_t max_rows,
                           int64_t n_cols, int64_t* rows_out,
                           int64_t* next_offset) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return -1;
  if (offset > 0 && fseeko(f, offset, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  LineReader r(f, offset);
  std::string line;
  int64_t row = 0;
  int64_t consumed = offset;
  bool first = (offset == 0);  // the header can only sit at the file head
  while (row < max_rows && r.next(&line)) {
    if (line.empty() || line[0] == '#') {
      consumed = r.offset();
      continue;
    }
    if (first && skip_header) {
      first = false;
      consumed = r.offset();
      continue;
    }
    first = false;
    parse_dense_line(line, sep, out + row * n_cols, n_cols);
    ++row;
    consumed = r.offset();
  }
  fclose(f);
  *rows_out = row;
  *next_offset = consumed;
  return 0;
}

int lgbt_parse_libsvm(const char* path, float* out, float* label_out,
                      int64_t n_rows, int64_t n_feat) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return -1;
  LineReader r(f);
  std::string line;
  int64_t row = 0;
  memset(out, 0, sizeof(float) * n_rows * n_feat);
  while (r.next(&line) && row < n_rows) {
    if (line.empty() || line[0] == '#') continue;
    parse_libsvm_line(line, out + row * n_feat, n_feat, &label_out[row]);
    ++row;
  }
  fclose(f);
  return row == n_rows ? 0 : -2;
}

int lgbt_parse_libsvm_range(const char* path, int64_t offset, float* out,
                            float* label_out, int64_t max_rows,
                            int64_t n_feat, int64_t* rows_out,
                            int64_t* next_offset) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return -1;
  if (offset > 0 && fseeko(f, offset, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  LineReader r(f, offset);
  std::string line;
  int64_t row = 0;
  int64_t consumed = offset;
  memset(out, 0, sizeof(float) * max_rows * n_feat);
  while (row < max_rows && r.next(&line)) {
    if (line.empty() || line[0] == '#') {
      consumed = r.offset();
      continue;
    }
    parse_libsvm_line(line, out + row * n_feat, n_feat, &label_out[row]);
    ++row;
    consumed = r.offset();
  }
  fclose(f);
  *rows_out = row;
  *next_offset = consumed;
  return 0;
}

}  // extern "C"
