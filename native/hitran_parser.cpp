// Native HITRAN .par parser (component C1's native data-loader tier).
//
// The reference (fedef17/SpectRobot) keeps its compiled code in Fortran
// inner loops; in this framework the COMPUTE hot loop is a Pallas GPU
// kernel, and the native C++ tier covers host-side data loading: parsing
// multi-million-line HITRAN catalogs at memory bandwidth instead of
// Python-object speed.  Exposed as a C ABI for ctypes (no pybind11 in this
// image).
//
// Record layout (160 chars + newline), HITRAN 2004+; see
// spectrobot_tpu/data/hitran.py for the authoritative field table.

#include <cctype>
#include <charconv>
#include <cstdint>
#include <cstring>

namespace {

// Parse a fixed-width field as double; blank -> 0.  Handles leading
// whitespace and Fortran-style floats ("-.0012", "3.456E-19").
static inline double parse_f(const char* p, int w) {
  int i = 0;
  while (i < w && (p[i] == ' ' || p[i] == '\t')) ++i;
  if (i == w) return 0.0;
  double v = 0.0;
  // std::from_chars(double) in libstdc++ accepts ".5" / "-.5" forms.
  auto res = std::from_chars(p + i, p + w, v, std::chars_format::general);
  if (res.ec != std::errc()) return 0.0;
  return v;
}

static inline int parse_i(const char* p, int w) {
  int i = 0;
  while (i < w && p[i] == ' ') ++i;
  int v = 0;
  bool any = false;
  for (; i < w; ++i) {
    if (p[i] < '0' || p[i] > '9') break;
    v = v * 10 + (p[i] - '0');
    any = true;
  }
  return any ? v : 0;
}

}  // namespace

extern "C" {

// Returns the number of parsed records (<= max_records), or -1 on error.
// quanta: 60 bytes per record (4 x 15-char fields, NOT null terminated).
long spectrobot_parse_par(
    const char* buf, long n_bytes,
    double* nu0, double* sw, double* a,
    double* gamma_air, double* gamma_self, double* elower,
    double* n_air, double* delta_air, double* gp, double* gpp,
    int32_t* mol_id, int32_t* iso_id, char* quanta,
    long max_records) {
  if (!buf || n_bytes <= 0) return 0;
  long k = 0;
  const char* p = buf;
  const char* end = buf + n_bytes;
  while (p < end && k < max_records) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    long len = line_end - p;
    if (len >= 67) {
      // Strip trailing CR.
      if (p[len - 1] == '\r') --len;
      mol_id[k] = parse_i(p + 0, 2);
      // HITRAN iso column: '1'-'9', '0' = 10, 'A' = 11, 'B' = 12.
      char ic = p[2];
      int iso;
      if (ic >= '1' && ic <= '9') iso = ic - '0';
      else if (ic == '0') iso = 10;
      else if (ic >= 'A' && ic <= 'Z') iso = 11 + (ic - 'A');
      else iso = 0;
      iso_id[k] = iso;
      nu0[k] = parse_f(p + 3, 12);
      sw[k] = parse_f(p + 15, 10);
      a[k] = parse_f(p + 25, 10);
      gamma_air[k] = parse_f(p + 35, 5);
      gamma_self[k] = parse_f(p + 40, 5);
      elower[k] = parse_f(p + 45, 10);
      n_air[k] = parse_f(p + 55, 4);
      delta_air[k] = parse_f(p + 59, 8);
      gp[k] = len >= 153 ? parse_f(p + 146, 7) : 0.0;
      gpp[k] = len >= 160 ? parse_f(p + 153, 7) : 0.0;
      char* q = quanta + 60 * k;
      for (int f = 0; f < 4; ++f) {
        long off = 67 + 15 * f;
        for (int c = 0; c < 15; ++c)
          q[15 * f + c] = (off + c < len) ? p[off + c] : ' ';
      }
      ++k;
    }
    if (!nl) break;
    p = nl + 1;
  }
  return k;
}

}  // extern "C"
