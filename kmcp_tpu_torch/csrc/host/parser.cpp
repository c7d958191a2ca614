// Read-batch packing for the device search: variable-length reads into the
// zero-padded row-major uint8 matrix that csrc/hash_loc.cu reads.
//
// The port's copy of kt_pack_rows from native/parser.cpp; the search-TSV
// parsers and merge scanners there serve profile and merge, which the port
// does not have yet.

#include <cstdint>
#include <cstring>

extern "C" {

// Pack variable-length reads into a zero-padded row-major [n, stride]
// uint8 matrix (the device batch layout).
void kt_pack_rows(const uint8_t* concat, const int64_t* offs, int64_t n,
                  int64_t stride, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    int64_t len = offs[i + 1] - offs[i];
    if (len > stride) len = stride;
    std::memcpy(out + i * stride, concat + offs[i], len);
    std::memset(out + i * stride + len, 0, stride - len);
  }
}

}  // extern "C"
