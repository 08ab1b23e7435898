// vireo-tpu native IO: streaming VCF -> CSR allele-count parser.
//
// The reference loads cell VCFs through a pure-Python line loop
// (/root/reference/vireoSNP/utils/vcf_utils.py:80-159 feeding :12-77),
// which dominates end-to-end wall clock once the engine itself runs on
// an accelerator.  This translation unit is a from-scratch C++17 streaming parser
// that produces exactly the arrays the engine needs — variant ids,
// sample ids, the 8 fixed columns, and per-FORMAT-tag CSR value arrays
// over non-missing entries — in one pass over the (b)gzip stream.
//
// Exposed through a plain C ABI (loaded from Python via ctypes, no
// pybind11).  Build: g++ -O3 -std=c++17 -shared -fPIC vcfio.cpp -lz.

#include <zlib.h>

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <utility>
#include <vector>

namespace {

// Chunked line reader over gzFile.  zlib's gz* layer transparently
// handles plain text, gzip, and bgzip (concatenated members).
class LineReader {
 public:
  explicit LineReader(const char* path) : f_(gzopen(path, "rb")) {
    if (f_ != nullptr) gzbuffer(f_, 1 << 20);
    buf_.resize(1 << 20);
  }
  ~LineReader() {
    if (f_ != nullptr) gzclose(f_);
  }
  bool ok() const { return f_ != nullptr; }

  // Returns false at EOF.  The returned view is valid until the next
  // call.  Strips trailing '\n' and '\r'.
  bool next(const char** line, size_t* len) {
    size_t start = pos_;
    for (;;) {
      // scan for newline in [pos_, end_)
      const char* nl = static_cast<const char*>(
          memchr(buf_.data() + pos_, '\n', end_ - pos_));
      if (nl != nullptr) {
        size_t eol = static_cast<size_t>(nl - buf_.data());
        *line = buf_.data() + start;
        *len = eol - start;
        while (*len > 0 && (*line)[*len - 1] == '\r') --*len;
        pos_ = eol + 1;
        return true;
      }
      // no newline: shift remainder to front and refill
      size_t rem = end_ - start;
      if (start > 0) {
        memmove(buf_.data(), buf_.data() + start, rem);
        start = 0;
        pos_ = rem;
        end_ = rem;
      }
      if (end_ == buf_.size()) buf_.resize(buf_.size() * 2);
      int n = gzread(f_, buf_.data() + end_,
                     static_cast<unsigned>(buf_.size() - end_));
      if (n < 0) return false;  // stream error: stop
      if (n == 0) {             // EOF: emit trailing partial line if any
        if (end_ > start) {
          *line = buf_.data() + start;
          *len = end_ - start;
          while (*len > 0 && (*line)[*len - 1] == '\r') --*len;
          pos_ = end_;
          return true;
        }
        return false;
      }
      end_ += static_cast<size_t>(n);
    }
  }

 private:
  gzFile f_;
  std::vector<char> buf_;
  size_t pos_ = 0;
  size_t end_ = 0;
};

// Split a line into tab-separated field views.
inline void split_tabs(const char* s, size_t len,
                       std::vector<std::pair<const char*, size_t>>* out) {
  out->clear();
  const char* p = s;
  const char* lim = s + len;
  while (p <= lim) {
    const char* tab = static_cast<const char*>(memchr(p, '\t', lim - p));
    if (tab == nullptr) {
      out->emplace_back(p, lim - p);
      break;
    }
    out->emplace_back(p, tab - p);
    p = tab + 1;
  }
}

// Parse the comma-field of a FORMAT value at `axis` (-1 = last) as a
// double; '.' -> 0 (read_sparse_GeneINFO semantics, vcf_utils.py:203).
inline double parse_axis_value(const char* s, size_t len, int axis) {
  const char* p = s;
  const char* lim = s + len;
  if (axis < 0) {
    const char* comma =
        static_cast<const char*>(memrchr(const_cast<char*>(s), ',', len));
    if (comma != nullptr) p = comma + 1;
  } else {
    for (int k = 0; k < axis && p < lim; ++k) {
      const char* comma = static_cast<const char*>(memchr(p, ',', lim - p));
      if (comma == nullptr) break;
      p = comma + 1;
    }
    const char* comma = static_cast<const char*>(memchr(p, ',', lim - p));
    if (comma != nullptr) lim = comma;
  }
  if (lim - p == 1 && *p == '.') return 0.0;
  char tmp[64];
  size_t n = static_cast<size_t>(lim - p);
  if (n >= sizeof(tmp)) n = sizeof(tmp) - 1;
  memcpy(tmp, p, n);
  tmp[n] = '\0';
  return strtod(tmp, nullptr);
}

// Bounded in-place integer parse (no NUL termination needed) —
// replaces the per-line memcpy + strtoll that dominated mtx parsing.
inline int64_t parse_int_fast(const char** pp, const char* lim) {
  const char* p = *pp;
  while (p < lim && (*p == ' ' || *p == '\t')) ++p;
  bool neg = false;
  if (p < lim && (*p == '+' || *p == '-')) {
    neg = (*p == '-');
    ++p;
  }
  int64_t v = 0;
  while (p < lim && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *pp = p;
  return neg ? -v : v;
}

// Numeric value parse with an integer fast path (count matrices are
// "integer" field); decimals/exponents fall back to strtod on a
// bounded copy.  An absent value ("pattern" field) reads as 1.0.
inline double parse_val_fast(const char** pp, const char* lim) {
  const char* p = *pp;
  while (p < lim && (*p == ' ' || *p == '\t')) ++p;
  if (p == lim) {
    *pp = p;
    return 1.0;
  }
  const char* s = p;
  bool neg = false;
  if (*p == '+' || *p == '-') {
    neg = (*p == '-');
    ++p;
  }
  int64_t ip = 0;
  while (p < lim && *p >= '0' && *p <= '9') ip = ip * 10 + (*p++ - '0');
  if (p == lim || *p == ' ' || *p == '\t') {
    *pp = p;
    return neg ? -static_cast<double>(ip) : static_cast<double>(ip);
  }
  char tmp[64];
  size_t n = static_cast<size_t>(lim - s);
  if (n >= sizeof(tmp)) n = sizeof(tmp) - 1;
  memcpy(tmp, s, n);
  tmp[n] = '\0';
  char* end;
  double v = strtod(tmp, &end);
  *pp = s + (end - tmp);
  return v;
}

inline bool all_dots(const char* s, size_t len) {
  // missing entry: "." or ".:.:..." — every ':'-field equals "."
  for (size_t i = 0; i < len; ++i) {
    if (s[i] == ':') continue;
    if (s[i] != '.') return false;
    if (i + 1 < len && s[i + 1] != ':') return false;
    if (i > 0 && s[i - 1] != ':') return false;
  }
  return len > 0;
}

struct CellVcfImpl {
  int64_t n_var = 0, n_samp = 0, nnz = 0;
  int32_t n_tags = 0;
  std::string variants;   // '\n'-joined variant ids CHROM_POS_REF_ALT
  std::string samples;    // '\n'-joined sample ids
  std::string fixed;      // '\n'-joined lines of 8 '\t'-joined columns
  std::string comments;   // '\n'-joined '##' header lines
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<double> values;  // tag-major: values[t*nnz + k]
  std::string error;
};

}  // namespace

extern "C" {

struct CellVcfView {
  int64_t n_var, n_samp, nnz;
  int32_t n_tags;
  const char* variants;
  const char* samples;
  const char* fixed;
  const char* comments;
  const int64_t* indptr;
  const int32_t* indices;
  const double* values;
  const char* error;
  void* impl;
};

// Parse `path`, extracting FORMAT tags in `tags_csv` (e.g. "AD,DP") at
// comma-axis `axes_csv` (e.g. "-1,-1").  biallelic_only skips variants
// with multi-base REF/ALT (vcf_utils.py:140-142).
CellVcfView* cellvcf_load(const char* path, const char* tags_csv,
                          const char* axes_csv, int biallelic_only) {
  auto* impl = new CellVcfImpl();
  auto* view = new CellVcfView();
  memset(view, 0, sizeof(*view));
  view->impl = impl;

  std::vector<std::string> tags;
  {
    const char* p = tags_csv;
    while (*p) {
      const char* c = strchr(p, ',');
      if (c == nullptr) {
        tags.emplace_back(p);
        break;
      }
      tags.emplace_back(p, c - p);
      p = c + 1;
    }
  }
  std::vector<int> axes(tags.size(), -1);
  {
    const char* p = axes_csv;
    for (size_t i = 0; i < tags.size() && *p; ++i) {
      axes[i] = atoi(p);
      const char* c = strchr(p, ',');
      if (c == nullptr) break;
      p = c + 1;
    }
  }
  impl->n_tags = static_cast<int32_t>(tags.size());

  LineReader reader(path);
  if (!reader.ok()) {
    impl->error = std::string("cannot open: ") + path;
    view->error = impl->error.c_str();
    return view;
  }

  std::vector<std::pair<const char*, size_t>> cols;
  std::vector<std::pair<const char*, size_t>> fmt_fields;
  std::vector<int> tag_idx(tags.size(), -1);
  std::string cur_format;
  std::vector<std::vector<double>> tag_vals(tags.size());

  impl->indptr.push_back(0);

  const char* line;
  size_t len;
  while (reader.next(&line, &len)) {
    if (len == 0) continue;
    if (line[0] == '#') {
      if (len >= 6 && memcmp(line, "#CHROM", 6) == 0) {
        split_tabs(line, len, &cols);
        for (size_t i = 9; i < cols.size(); ++i) {
          if (!impl->samples.empty()) impl->samples += '\n';
          impl->samples.append(cols[i].first, cols[i].second);
          ++impl->n_samp;
        }
      } else {
        if (!impl->comments.empty()) impl->comments += '\n';
        impl->comments.append(line, len);
      }
      continue;
    }
    split_tabs(line, len, &cols);
    if (cols.size() < 8) continue;
    if (biallelic_only && (cols[3].second > 1 || cols[4].second > 1)) continue;

    // variant id CHROM_POS_REF_ALT (vcf_utils.py:153)
    if (!impl->variants.empty()) impl->variants += '\n';
    impl->variants.append(cols[0].first, cols[0].second);
    impl->variants += '_';
    impl->variants.append(cols[1].first, cols[1].second);
    impl->variants += '_';
    impl->variants.append(cols[3].first, cols[3].second);
    impl->variants += '_';
    impl->variants.append(cols[4].first, cols[4].second);

    // 8 fixed columns, '\t'-joined
    if (!impl->fixed.empty()) impl->fixed += '\n';
    impl->fixed.append(cols[0].first,
                       (cols[7].first + cols[7].second) - cols[0].first);

    if (cols.size() > 9 && !tags.empty()) {
      // resolve tag positions within FORMAT (memoized on the string)
      if (cur_format.size() != cols[8].second ||
          memcmp(cur_format.data(), cols[8].first, cols[8].second) != 0) {
        cur_format.assign(cols[8].first, cols[8].second);
        fmt_fields.clear();
        const char* p = cols[8].first;
        const char* lim = p + cols[8].second;
        while (p <= lim) {
          const char* c = static_cast<const char*>(memchr(p, ':', lim - p));
          size_t flen = (c == nullptr ? lim : c) - p;
          fmt_fields.emplace_back(p, flen);
          if (c == nullptr) break;
          p = c + 1;
        }
        for (size_t t = 0; t < tags.size(); ++t) {
          tag_idx[t] = -1;
          for (size_t k = 0; k < fmt_fields.size(); ++k) {
            if (fmt_fields[k].second == tags[t].size() &&
                memcmp(fmt_fields[k].first, tags[t].data(),
                       tags[t].size()) == 0) {
              tag_idx[t] = static_cast<int>(k);
              break;
            }
          }
        }
      }

      for (size_t i = 9; i < cols.size(); ++i) {
        const char* e = cols[i].first;
        size_t elen = cols[i].second;
        if ((elen == 1 && e[0] == '.') || all_dots(e, elen)) continue;
        impl->indices.push_back(static_cast<int32_t>(i - 9));
        // split entry on ':' and pull each tag's field
        for (size_t t = 0; t < tags.size(); ++t) {
          int want = tag_idx[t];
          const char* p = e;
          const char* lim = e + elen;
          const char* fs = p;
          size_t flen = elen;
          if (want < 0) {
            tag_vals[t].push_back(0.0);
            continue;
          }
          for (int k = 0; k <= want; ++k) {
            const char* c =
                static_cast<const char*>(memchr(p, ':', lim - p));
            fs = p;
            flen = (c == nullptr ? lim : c) - p;
            if (c == nullptr) break;
            p = c + 1;
          }
          tag_vals[t].push_back(parse_axis_value(fs, flen, axes[t]));
        }
      }
    }
    impl->indptr.push_back(static_cast<int64_t>(impl->indices.size()));
    ++impl->n_var;
  }

  impl->nnz = static_cast<int64_t>(impl->indices.size());
  impl->values.resize(static_cast<size_t>(impl->nnz) * tags.size());
  for (size_t t = 0; t < tags.size(); ++t) {
    memcpy(impl->values.data() + t * impl->nnz, tag_vals[t].data(),
           sizeof(double) * tag_vals[t].size());
  }

  view->n_var = impl->n_var;
  view->n_samp = impl->n_samp;
  view->nnz = impl->nnz;
  view->n_tags = impl->n_tags;
  view->variants = impl->variants.c_str();
  view->samples = impl->samples.c_str();
  view->fixed = impl->fixed.c_str();
  view->comments = impl->comments.c_str();
  view->indptr = impl->indptr.data();
  view->indices = impl->indices.data();
  view->values = impl->values.data();
  view->error = nullptr;
  return view;
}

void cellvcf_free(CellVcfView* view) {
  if (view == nullptr) return;
  delete static_cast<CellVcfImpl*>(view->impl);
  delete view;
}

// True when the MatrixMarket banner declares the one layout these
// readers implement: "coordinate" entries of a numeric "real" /
// "integer" field with "general" symmetry.  Anything else ("array"
// would mis-parse its 2-field size line as nnz=0; "symmetric" stores
// only one triangle; "pattern" has 2-field entry lines; "complex" has
// 4) must return -1 so the caller falls back to scipy.io.mmread,
// which handles every variant.
static bool mm_banner_supported(const char* line, size_t len) {
  std::string banner(line, len);
  for (char& c : banner) c = static_cast<char>(tolower(c));
  return banner.find("coordinate") != std::string::npos &&
         banner.find("general") != std::string::npos &&
         (banner.find("real") != std::string::npos ||
          banner.find("integer") != std::string::npos);
}

// Fast MatrixMarket coordinate reader: fills row/col/val arrays.
// Returns nnz on success, -1 on error.  Two-call protocol: first call
// with rows==nullptr to get dims+nnz, then with allocated buffers.
int64_t mmread_coo(const char* path, int64_t* shape_out, int32_t* rows,
                   int32_t* cols, double* vals) {
  LineReader reader(path);
  if (!reader.ok()) return -1;
  const char* line;
  size_t len;
  // header
  if (!reader.next(&line, &len)) return -1;
  if (len < 14 || memcmp(line, "%%MatrixMarket", 14) != 0) return -1;
  if (!mm_banner_supported(line, len)) return -1;
  // skip comments
  for (;;) {
    if (!reader.next(&line, &len)) return -1;
    if (len > 0 && line[0] != '%') break;
  }
  char tmp[128];
  size_t n = len < sizeof(tmp) - 1 ? len : sizeof(tmp) - 1;
  memcpy(tmp, line, n);
  tmp[n] = '\0';
  char* end;
  int64_t n_row = strtoll(tmp, &end, 10);
  int64_t n_col = strtoll(end, &end, 10);
  int64_t nnz = strtoll(end, &end, 10);
  shape_out[0] = n_row;
  shape_out[1] = n_col;
  shape_out[2] = nnz;
  if (rows == nullptr) return nnz;

  int64_t k = 0;
  while (k < nnz && reader.next(&line, &len)) {
    if (len == 0) continue;
    const char* p = line;
    const char* lim = line + len;
    rows[k] = static_cast<int32_t>(parse_int_fast(&p, lim) - 1);
    cols[k] = static_cast<int32_t>(parse_int_fast(&p, lim) - 1);
    vals[k] = parse_val_fast(&p, lim);
    ++k;
  }
  return k;
}

// MatrixMarket coordinate file -> canonical CSC in one native pass.
// Counting sort by column (O(nnz)) replaces scipy's COO->CSC
// conversion, which costs ~2x the parse itself at 30M entries.
// Two-call protocol like mmread_coo: first call with indptr==nullptr
// fills shape_out {n_row, n_col, nnz}; the second fills indptr
// (n_col+1 int64), indices (nnz int32, row ids sorted within each
// column) and vals (nnz double).  Returns nnz, -1 on parse error, or
// -2 when duplicate (row, col) entries exist (caller must fall back
// to a summing builder).
int64_t mmread_csc(const char* path, int64_t* shape_out, int64_t* indptr,
                   int32_t* indices, double* vals) {
  LineReader reader(path);
  if (!reader.ok()) return -1;
  const char* line;
  size_t len;
  if (!reader.next(&line, &len)) return -1;
  if (len < 14 || memcmp(line, "%%MatrixMarket", 14) != 0) return -1;
  if (!mm_banner_supported(line, len)) return -1;
  for (;;) {
    if (!reader.next(&line, &len)) return -1;
    if (len > 0 && line[0] != '%') break;
  }
  {
    const char* p = line;
    const char* lim = line + len;
    shape_out[0] = parse_int_fast(&p, lim);
    shape_out[1] = parse_int_fast(&p, lim);
    shape_out[2] = parse_int_fast(&p, lim);
  }
  int64_t n_row = shape_out[0];
  int64_t n_col = shape_out[1];
  int64_t nnz = shape_out[2];
  if (nnz < 0 || n_row < 0 || n_col < 0) return -1;
  if (indptr == nullptr) return nnz;

  std::vector<int32_t> rows, cols;
  std::vector<double> v;
  try {
    rows.resize(nnz);
    cols.resize(nnz);
    v.resize(nnz);
  } catch (const std::bad_alloc&) {
    return -1;  // header promised more entries than memory allows
  }
  int64_t k = 0;
  while (k < nnz && reader.next(&line, &len)) {
    if (len == 0) continue;
    const char* p = line;
    const char* lim = line + len;
    rows[k] = static_cast<int32_t>(parse_int_fast(&p, lim) - 1);
    cols[k] = static_cast<int32_t>(parse_int_fast(&p, lim) - 1);
    v[k] = parse_val_fast(&p, lim);
    ++k;
  }
  if (k != nnz) return -1;

  // stable counting sort by column
  memset(indptr, 0, sizeof(int64_t) * (n_col + 1));
  for (int64_t i = 0; i < nnz; ++i) {
    if (cols[i] < 0 || cols[i] >= n_col) return -1;
    if (rows[i] < 0 || rows[i] >= n_row) return -1;
    ++indptr[cols[i] + 1];
  }
  for (int64_t c = 0; c < n_col; ++c) indptr[c + 1] += indptr[c];
  std::vector<int64_t> next(indptr, indptr + n_col);
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t dst = next[cols[i]]++;
    indices[dst] = rows[i];
    vals[dst] = v[i];
  }
  // canonicalize: sort rows within any column the file order left
  // unsorted (row-major and column-major files are already sorted)
  std::vector<std::pair<int32_t, double>> scratch;
  for (int64_t c = 0; c < n_col; ++c) {
    int64_t lo = indptr[c], hi = indptr[c + 1];
    bool sorted = true;
    for (int64_t i = lo + 1; i < hi; ++i) {
      if (indices[i] <= indices[i - 1]) {
        if (indices[i] == indices[i - 1]) return -2;  // duplicate
        sorted = false;
      }
    }
    if (sorted) continue;
    scratch.resize(hi - lo);
    for (int64_t i = lo; i < hi; ++i)
      scratch[i - lo] = {indices[i], vals[i]};
    std::sort(scratch.begin(), scratch.end());
    for (int64_t i = lo; i < hi; ++i) {
      indices[i] = scratch[i - lo].first;
      vals[i] = scratch[i - lo].second;
      if (i > lo && indices[i] == indices[i - 1]) return -2;
    }
  }
  return nnz;
}

// Write a names + formatted-matrix TSV: `header` as the first line,
// then one line per row: names[i] '\t' fmt%mat[i,0] ... '\t'
// fmt%mat[i,n_cols-1].  `names` is a '\n'-joined blob with n_rows
// entries.  glibc snprintf's %.*e output is byte-identical to
// Python's float __mod__ (both correctly rounded, two-digit minimum
// exponent) — verified by fuzz test.  `gzip_level` > 0 writes a gzip
// member in the same pass (no temp file + `gzip` subprocess);
// 0 writes plain bytes.  Returns 0 on success, -1 on error.  This
// replaces a Python per-value format loop + external gzip that cost
// ~17 s at the 100k-cell scale.
int64_t write_matrix_tsv(const char* path, const char* header,
                         const char* names, const double* mat,
                         int64_t n_rows, int64_t n_cols, const char* fmt,
                         int32_t gzip_level) {
  char mode[8];
  if (gzip_level > 0)
    snprintf(mode, sizeof(mode), "wb%d", gzip_level > 9 ? 9 : gzip_level);
  else
    snprintf(mode, sizeof(mode), "wbT");  // 'T': transparent (no gzip)
  gzFile f = gzopen(path, mode);
  if (f == nullptr) return -1;
  gzbuffer(f, 1 << 20);

  std::string out;
  out.reserve(1 << 20);
  bool ok = true;
  auto flush = [&](size_t keep_below) {
    if (out.size() >= keep_below) {
      if (gzwrite(f, out.data(), static_cast<unsigned>(out.size())) !=
          static_cast<int>(out.size()))
        ok = false;
      out.clear();
    }
  };

  out.append(header);
  out.push_back('\n');
  const char* name = names;
  char buf[64];
  for (int64_t i = 0; i < n_rows && ok; ++i) {
    const char* nl = strchr(name, '\n');
    size_t nlen = nl ? static_cast<size_t>(nl - name) : strlen(name);
    out.append(name, nlen);
    name = nl ? nl + 1 : name + nlen;
    const double* row = mat + i * n_cols;
    for (int64_t j = 0; j < n_cols; ++j) {
      buf[0] = '\t';
      // snprintf returns the untruncated would-be length; a value that
      // does not fit the buffer is a caller error (fmt is a parameter)
      int m = snprintf(buf + 1, sizeof(buf) - 1, fmt, row[j]);
      if (m < 0 || m >= static_cast<int>(sizeof(buf)) - 1) {
        ok = false;
        break;
      }
      out.append(buf, static_cast<size_t>(m + 1));
    }
    out.push_back('\n');
    flush(1 << 19);
  }
  flush(1);
  int rc = gzclose(f);
  return (ok && rc == Z_OK) ? 0 : -1;
}

// Union merge of two canonical CSR matrices (same shape): emits
// (row, col)-sorted triplets over the union nonzero pattern with each
// matrix's value (0 where absent) — the alignment pass every count
// layout builds from.  Two-call protocol: with out_rows == nullptr
// returns the union nnz; the second call fills out_rows/out_cols
// (int32) and out_a/out_d (double).  Rows within each matrix must be
// strictly sorted with no duplicates (scipy canonical form; the
// caller guarantees it).  Returns union nnz, or -1 on error.
int64_t union_csr(int64_t n_row, const int64_t* a_indptr,
                  const int32_t* a_indices, const double* a_data,
                  const int64_t* d_indptr, const int32_t* d_indices,
                  const double* d_data, int32_t* out_rows,
                  int32_t* out_cols, double* out_a, double* out_d) {
  if (out_rows == nullptr) {
    int64_t nnz = 0;
    for (int64_t r = 0; r < n_row; ++r) {
      int64_t i = a_indptr[r], ie = a_indptr[r + 1];
      int64_t j = d_indptr[r], je = d_indptr[r + 1];
      while (i < ie && j < je) {
        int32_t ca = a_indices[i], cd = d_indices[j];
        i += (ca <= cd);
        j += (cd <= ca);
        ++nnz;
      }
      nnz += (ie - i) + (je - j);
    }
    return nnz;
  }
  int64_t k = 0;
  for (int64_t r = 0; r < n_row; ++r) {
    int64_t i = a_indptr[r], ie = a_indptr[r + 1];
    int64_t j = d_indptr[r], je = d_indptr[r + 1];
    while (i < ie || j < je) {
      int32_t ca = i < ie ? a_indices[i] : INT32_MAX;
      int32_t cd = j < je ? d_indices[j] : INT32_MAX;
      int32_t c = ca < cd ? ca : cd;
      out_rows[k] = static_cast<int32_t>(r);
      out_cols[k] = c;
      out_a[k] = (ca == c) ? a_data[i] : 0.0;
      out_d[k] = (cd == c) ? d_data[j] : 0.0;
      i += (ca == c);
      j += (cd == c);
      ++k;
    }
  }
  return k;
}

// ---- fused placement encoder ---------------------------------------
// Union of two same-shape canonical CSC count matrices, emitted
// ROW-major in the transfer encoding the device scatter consumes
// (ops/counts.py _triplet_device_args): CSR row pointer, column ids,
// nibble-packed values with exception lists.  Replaces a chain of
// scipy CSC->CSR conversions + numpy passes that cost ~15-19 s at 30M
// nnz on the disk-to-answer path; these three flat passes run in
// well under a second.
//
// encode_counts_stats: merge-count -> stats {nnz, n_val_exc, vmax}
//   (vmax is the true unclipped maximum — the representation ladder
//   keys on it).
// encode_counts_fill:  counting-sort placement -> row_ptr (int32,
//   n_row+1), cols (int32, nnz, (row, col)-sorted), vals (uint8,
//   ad | dp << 4 where both clipped values fit a nibble, else 0 with
//   an exception entry), val_exc_{pos(int32), ad(int8), dp(int8)}
//   sorted by position.  Values clip at 127 (the int8 transfer
//   contract).  Returns nnz, or -1 when nnz/exceptions do not match
//   the stats call or nnz exceeds int32 range.
// delta_encode_cols:   sequential uint8 forward-delta encoding of a
//   column-id array (two-call: deltas == nullptr returns the
//   exception count; exceptions are deltas < 0 or >= 256).

static inline int clip127(double v) {
  int64_t x = static_cast<int64_t>(v);
  return x > 127 ? 127 : static_cast<int>(x);
}

int64_t encode_counts_stats(int64_t n_col, const int64_t* a_indptr,
                            const int32_t* a_indices, const double* a_data,
                            const int64_t* d_indptr,
                            const int32_t* d_indices, const double* d_data,
                            int64_t* stats_out) {
  int64_t nnz = 0, n_val_exc = 0, n_over = 0;
  double vmax = 0.0;
  for (int64_t c = 0; c < n_col; ++c) {
    int64_t i = a_indptr[c], ie = a_indptr[c + 1];
    int64_t j = d_indptr[c], je = d_indptr[c + 1];
    while (i < ie || j < je) {
      int32_t ra = i < ie ? a_indices[i] : INT32_MAX;
      int32_t rd = j < je ? d_indices[j] : INT32_MAX;
      int32_t r = ra < rd ? ra : rd;
      double a = (ra == r) ? a_data[i] : 0.0;
      double d = (rd == r) ? d_data[j] : 0.0;
      if (a > vmax) vmax = a;
      if (d > vmax) vmax = d;
      if (clip127(a) > 15 || clip127(d) > 15) ++n_val_exc;
      if (a > 127.0 || d > 127.0) ++n_over;   // hybrid residual size
      i += (ra == r);
      j += (rd == r);
      ++nnz;
    }
  }
  stats_out[0] = nnz;
  stats_out[1] = n_val_exc;
  // ceil: a fractional max must not under-report past a dtype cutoff
  stats_out[2] = static_cast<int64_t>(vmax) +
                 (vmax > static_cast<double>(static_cast<int64_t>(vmax)));
  stats_out[3] = n_over;
  return nnz;
}

int64_t encode_counts_fill(int64_t n_row, int64_t n_col,
                           const int64_t* a_indptr,
                           const int32_t* a_indices, const double* a_data,
                           const int64_t* d_indptr,
                           const int32_t* d_indices, const double* d_data,
                           int64_t nnz_expect, int64_t val_exc_expect,
                           int32_t* row_ptr, int32_t* cols, uint8_t* vals,
                           int32_t* val_exc_pos, int8_t* val_exc_ad,
                           int8_t* val_exc_dp) {
  if (nnz_expect > INT32_MAX) return -1;
  std::vector<int64_t> cnt(static_cast<size_t>(n_row) + 1, 0);
  for (int64_t c = 0; c < n_col; ++c) {
    int64_t i = a_indptr[c], ie = a_indptr[c + 1];
    int64_t j = d_indptr[c], je = d_indptr[c + 1];
    while (i < ie && j < je) {
      int32_t ra = a_indices[i], rd = d_indices[j];
      int32_t r = ra < rd ? ra : rd;
      ++cnt[r + 1];
      i += (ra <= rd);
      j += (rd <= ra);
    }
    for (; i < ie; ++i) ++cnt[a_indices[i] + 1];
    for (; j < je; ++j) ++cnt[d_indices[j] + 1];
  }
  for (int64_t r = 0; r < n_row; ++r) cnt[r + 1] += cnt[r];
  if (cnt[n_row] != nnz_expect) return -1;
  for (int64_t r = 0; r <= n_row; ++r)
    row_ptr[r] = static_cast<int32_t>(cnt[r]);

  std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
  struct Exc { int32_t pos; int8_t ad, dp; };
  std::vector<Exc> exc;
  exc.reserve(static_cast<size_t>(val_exc_expect));
  for (int64_t c = 0; c < n_col; ++c) {
    int64_t i = a_indptr[c], ie = a_indptr[c + 1];
    int64_t j = d_indptr[c], je = d_indptr[c + 1];
    while (i < ie || j < je) {
      int32_t ra = i < ie ? a_indices[i] : INT32_MAX;
      int32_t rd = j < je ? d_indices[j] : INT32_MAX;
      int32_t r = ra < rd ? ra : rd;
      int a = clip127((ra == r) ? a_data[i] : 0.0);
      int d = clip127((rd == r) ? d_data[j] : 0.0);
      int64_t pos = cur[r]++;
      cols[pos] = static_cast<int32_t>(c);
      if (a > 15 || d > 15) {
        vals[pos] = 0;
        exc.push_back({static_cast<int32_t>(pos),
                       static_cast<int8_t>(a), static_cast<int8_t>(d)});
      } else {
        vals[pos] = static_cast<uint8_t>(a | (d << 4));
      }
      i += (ra == r);
      j += (rd == r);
    }
  }
  if (static_cast<int64_t>(exc.size()) != val_exc_expect) return -1;
  // columns fill positions out of row-major order; exceptions sort to
  // ascending position to match the numpy encoder exactly
  std::sort(exc.begin(), exc.end(),
            [](const Exc& x, const Exc& y) { return x.pos < y.pos; });
  for (size_t k = 0; k < exc.size(); ++k) {
    val_exc_pos[k] = exc[k].pos;
    val_exc_ad[k] = exc[k].ad;
    val_exc_dp[k] = exc[k].dp;
  }
  return cnt[n_row];
}

// Union entries whose TRUE value exceeds the int8 transfer cap (127)
// on either side — the hybrid rung's overflow residual.  Two-call
// protocol: out_rows == nullptr returns the count; the second call
// fills row/col (int32) and the true ad/dp values (double), refusing
// (-1) when more than max_n would be written.
int64_t collect_overflow_csc(int64_t n_col, const int64_t* a_indptr,
                             const int32_t* a_indices,
                             const double* a_data,
                             const int64_t* d_indptr,
                             const int32_t* d_indices,
                             const double* d_data, int32_t* out_rows,
                             int32_t* out_cols, double* out_ad,
                             double* out_dp, int64_t max_n) {
  int64_t k = 0;
  for (int64_t c = 0; c < n_col; ++c) {
    int64_t i = a_indptr[c], ie = a_indptr[c + 1];
    int64_t j = d_indptr[c], je = d_indptr[c + 1];
    while (i < ie || j < je) {
      int32_t ra = i < ie ? a_indices[i] : INT32_MAX;
      int32_t rd = j < je ? d_indices[j] : INT32_MAX;
      int32_t r = ra < rd ? ra : rd;
      double a = (ra == r) ? a_data[i] : 0.0;
      double d = (rd == r) ? d_data[j] : 0.0;
      if (a > 127.0 || d > 127.0) {
        if (out_rows != nullptr) {
          if (k >= max_n) return -1;
          out_rows[k] = r;
          out_cols[k] = static_cast<int32_t>(c);
          out_ad[k] = a;
          out_dp[k] = d;
        }
        ++k;
      }
      i += (ra == r);
      j += (rd == r);
    }
  }
  return k;
}

int64_t delta_encode_cols(const int32_t* cols, int64_t n, uint8_t* deltas,
                          int32_t* exc_pos, int32_t* exc_val,
                          int64_t max_exc) {
  if (deltas == nullptr) {
    int64_t n_exc = 0;
    int32_t prev = 0;
    for (int64_t k = 0; k < n; ++k) {
      int64_t d = static_cast<int64_t>(cols[k]) - prev;
      n_exc += (d < 0 || d >= 256);
      prev = cols[k];
    }
    return n_exc;
  }
  int64_t n_exc = 0;
  int32_t prev = 0;
  for (int64_t k = 0; k < n; ++k) {
    int64_t d = static_cast<int64_t>(cols[k]) - prev;
    if (d < 0 || d >= 256) {
      if (n_exc >= max_exc) return -1;
      deltas[k] = 0;
      exc_pos[n_exc] = static_cast<int32_t>(k);
      exc_val[n_exc] = static_cast<int32_t>(d);
      ++n_exc;
    } else {
      deltas[k] = static_cast<uint8_t>(d);
    }
    prev = cols[k];
  }
  return n_exc;
}

}  // extern "C"
