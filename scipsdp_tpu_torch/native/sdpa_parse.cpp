// Fast tokenizer for the extended sparse SDPA format (.dat-s).
//
// Native-path analog of the reference's C reader front end
// (src/scipsdp/reader_sdpa.c tokenization); the Python reader
// (models/reader_sdpa.py) performs validation and assembly on the
// returned arrays and falls back to pure Python on any error here.
//
// Two-pass C API (caller allocates numpy buffers after the count pass):
//
//   sdpa_count(path, &nvars, &nblocks, &nentries, &nint, &nrank1) -> 0/err
//   sdpa_fill (path, blocksizes[nblocks], obj[nvars],
//              var/block/row/col[nentries], val[nentries],
//              intidx[nint], rank1idx[nrank1]) -> 0/err
//
// Build:  g++ -O3 -shared -fPIC -o libsdpaparse.so sdpa_parse.cpp

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Parsed {
  long nvars = 0;
  long nblocks = 0;
  std::vector<long> blocksizes;
  std::vector<double> obj;
  std::vector<long> var, block, row, col;
  std::vector<double> val;
  std::vector<long> intidx;
  std::vector<long> rank1idx;
};

// strip comments ('*' or '"' to end of line); returns trimmed view
inline void strip_comment(std::string &line) {
  size_t p = line.find_first_of("*\"");
  if (p != std::string::npos) line.erase(p);
}

inline bool parse_longs(const char *s, std::vector<long> &out, long want) {
  char *end;
  for (long k = 0; k < want; ++k) {
    long v = strtol(s, &end, 10);
    if (end == s) return false;
    out.push_back(v);
    s = end;
    // tolerate trailing junk glued to the number (e.g. "-4=")
    while (*s && !isspace(static_cast<unsigned char>(*s)) &&
           *s != '-' && *s != '+' && !isdigit(static_cast<unsigned char>(*s)))
      ++s;
  }
  return true;
}

int parse_file(const char *path, Parsed &P) {
  FILE *f = fopen(path, "r");
  if (!f) return 1;
  std::string line;
  char buf[1 << 16];
  int stage = 0;  // 0 nvars, 1 nblocks, 2 sizes, 3 obj, 4 entries
  int section = 0;  // 0 data, 1 INTEGER, 2 RANK1
  while (fgets(buf, sizeof buf, f)) {
    line.assign(buf);
    // extension sections are comment lines
    if (line.rfind("*INTEGER", 0) == 0) {
      if (section == 2) { fclose(f); return 2; }
      section = 1;
      continue;
    }
    if (line.rfind("*RANK1", 0) == 0) {
      section = 2;
      continue;
    }
    if (section != 0) {
      size_t i = 0;
      while (i < line.size() && isspace(static_cast<unsigned char>(line[i])))
        ++i;
      if (i >= line.size()) continue;
      if (line[i] != '*') { fclose(f); return 3; }
      char *end;
      long idx = strtol(line.c_str() + i + 1, &end, 10);
      if (end == line.c_str() + i + 1) { fclose(f); return 4; }
      (section == 1 ? P.intidx : P.rank1idx).push_back(idx);
      continue;
    }
    strip_comment(line);
    // trim
    size_t b = line.find_first_not_of(" \t\r\n");
    if (b == std::string::npos) continue;
    const char *s = line.c_str() + b;
    char *end;
    switch (stage) {
      case 0: {
        P.nvars = strtol(s, &end, 10);
        if (end == s) { fclose(f); return 5; }
        stage = 1;
        break;
      }
      case 1: {
        P.nblocks = strtol(s, &end, 10);
        if (end == s) { fclose(f); return 6; }
        stage = 2;
        break;
      }
      case 2: {
        if (P.nblocks < 0 || !parse_longs(s, P.blocksizes, P.nblocks)) {
          fclose(f);
          return 7;
        }
        stage = 3;
        break;
      }
      case 3: {
        for (long k = 0; k < P.nvars; ++k) {
          double v = strtod(s, &end);
          if (end == s) { fclose(f); return 8; }
          P.obj.push_back(v);
          s = end;
        }
        stage = 4;
        break;
      }
      default: {
        long a[4];
        const char *t = s;
        bool ok = true;
        for (int k = 0; k < 4; ++k) {
          a[k] = strtol(t, &end, 10);
          if (end == t) { ok = false; break; }
          t = end;
        }
        if (!ok) { fclose(f); return 9; }
        double v = strtod(t, &end);
        if (end == t) { fclose(f); return 9; }
        P.var.push_back(a[0]);
        P.block.push_back(a[1]);
        P.row.push_back(a[2]);
        P.col.push_back(a[3]);
        P.val.push_back(v);
        break;
      }
    }
  }
  fclose(f);
  if (stage < 4) return 10;
  return 0;
}

}  // namespace

extern "C" {

int sdpa_count(const char *path, long *nvars, long *nblocks, long *nentries,
               long *nint, long *nrank1) {
  Parsed P;
  int rc = parse_file(path, P);
  if (rc) return rc;
  *nvars = P.nvars;
  *nblocks = P.nblocks;
  *nentries = static_cast<long>(P.val.size());
  *nint = static_cast<long>(P.intidx.size());
  *nrank1 = static_cast<long>(P.rank1idx.size());
  return 0;
}

int sdpa_fill(const char *path, long *blocksizes, double *obj, long *var,
              long *block, long *row, long *col, double *val, long *intidx,
              long *rank1idx) {
  Parsed P;
  int rc = parse_file(path, P);
  if (rc) return rc;
  memcpy(blocksizes, P.blocksizes.data(), P.blocksizes.size() * sizeof(long));
  memcpy(obj, P.obj.data(), P.obj.size() * sizeof(double));
  memcpy(var, P.var.data(), P.var.size() * sizeof(long));
  memcpy(block, P.block.data(), P.block.size() * sizeof(long));
  memcpy(row, P.row.data(), P.row.size() * sizeof(long));
  memcpy(col, P.col.data(), P.col.size() * sizeof(long));
  memcpy(val, P.val.data(), P.val.size() * sizeof(double));
  memcpy(intidx, P.intidx.data(), P.intidx.size() * sizeof(long));
  memcpy(rank1idx, P.rank1idx.data(), P.rank1idx.size() * sizeof(long));
  return 0;
}
}
