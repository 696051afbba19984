// Fast numeric text-table parser (host-side native component).
//
// A copy of octofitter_tpu/native/fasttable.cpp. The reference framework
// is pure Julia with compiled-by-default IO; the Python host layer uses
// this C++ parser for its text table hot paths: GOST scan-law CSVs
// (hundreds of files x thousands of rows in survey-scale workflows,
// `gaia-utils.jl:709-831`), Hipparcos IAD data blocks
// (`hipparcos.jl:129-390`), and RV archive tables. Non-numeric fields
// parse as NaN so mixed string/number tables (e.g. GOST's Target column)
// keep rectangular shape; callers map columns by header on the Python
// side.
//
// C ABI only, loaded with ctypes (native/__init__.py builds it with g++).

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parse `path` into a row-major double matrix.
//   skip:       leading lines to skip (e.g. 1 for a header).
//   delimiter:  ',' etc., or 0 for whitespace tokenization.
//   comment:    lines starting with this char are ignored (0 = none).
// Returns 0 on success; 1 open failure; 2 read failure; 3 ragged rows.
// On success *out_data is malloc'd (free with fasttable_free),
// *out_rows x *out_cols gives the shape.
int fasttable_parse(const char* path, long skip, char delimiter,
                    char comment, double** out_data, long* out_rows,
                    long* out_cols) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    if (size > 0 && std::fread(buf.data(), 1, size, f) != (size_t)size) {
        std::fclose(f);
        return 2;
    }
    std::fclose(f);
    buf[size] = '\0';

    std::vector<double> data;
    data.reserve(1 << 16);
    long ncols = -1, nrows = 0, lineno = 0;
    char* p = buf.data();
    char* end = buf.data() + size;

    while (p < end) {
        char* line_end = static_cast<char*>(memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        char* next = (line_end < end) ? line_end + 1 : end;
        *line_end = '\0';
        lineno++;

        char* q = p;
        while (*q == ' ' || *q == '\t' || *q == '\r') q++;
        bool ignore = (lineno <= skip) || (*q == '\0') ||
                      (comment && *q == comment);
        if (!ignore) {
            long c = 0;
            if (delimiter) {
                char* field = q;
                for (;;) {
                    char* sep = static_cast<char*>(
                        memchr(field, delimiter, line_end - field));
                    if (sep) *sep = '\0';
                    char* te;
                    double v = std::strtod(field, &te);
                    if (te == field) v = NAN;
                    data.push_back(v);
                    c++;
                    if (!sep) break;
                    field = sep + 1;
                }
            } else {
                char* s = q;
                while (s < line_end) {
                    while (s < line_end &&
                           (*s == ' ' || *s == '\t' || *s == '\r'))
                        s++;
                    if (s >= line_end || *s == '\0') break;
                    char* te;
                    double v = std::strtod(s, &te);
                    if (te == s) {
                        v = NAN;
                        while (s < line_end && *s != ' ' && *s != '\t' &&
                               *s != '\0')
                            s++;
                    } else {
                        s = te;
                    }
                    data.push_back(v);
                    c++;
                }
            }
            if (c > 0) {
                if (ncols < 0) ncols = c;
                if (c != ncols) return 3;
                nrows++;
            }
        }
        p = next;
    }

    if (ncols < 0) ncols = 0;
    double* out = static_cast<double*>(
        std::malloc(sizeof(double) * (data.empty() ? 1 : data.size())));
    if (!out) return 4;
    if (!data.empty())
        std::memcpy(out, data.data(), sizeof(double) * data.size());
    *out_data = out;
    *out_rows = nrows;
    *out_cols = ncols;
    return 0;
}

void fasttable_free(double* p) { std::free(p); }

}  // extern "C"
