// PNG row unfiltering (PNG specification, section 9): undoes the five row
// filters of a decompressed, non-interlaced image in one call. Built by
// utils/native.py with g++ and bound with ctypes in data/png.py, whose
// _unfilter is the plain version it is held against.
//
//   pu_unfilter(raw, height, stride, bpp, out)
//     raw:    height * (stride + 1) bytes, each row a filter-type byte then
//             `stride` filtered bytes
//     out:    height * stride bytes, the unfiltered rows
//     bpp:    bytes per complete pixel, 1 to 8
//   returns 0, or 1 + the index of the first row whose filter type is unknown
//   (its rows from there on are left unwritten).
#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" long pu_unfilter(const uint8_t* raw, long height, long stride, int bpp,
                            uint8_t* out) {
    for (long y = 0; y < height; ++y) {
        const uint8_t kind = raw[y * (stride + 1)];
        const uint8_t* row = raw + y * (stride + 1) + 1;
        uint8_t* cur = out + y * stride;
        // the row above; the first row's is all zeros
        const uint8_t* up = y > 0 ? out + (y - 1) * stride : nullptr;
        switch (kind) {
            case 0:  // None
                for (long i = 0; i < stride; ++i) cur[i] = row[i];
                break;
            case 1:  // Sub
                for (long i = 0; i < stride; ++i)
                    cur[i] = static_cast<uint8_t>(row[i] + (i >= bpp ? cur[i - bpp] : 0));
                break;
            case 2:  // Up
                for (long i = 0; i < stride; ++i)
                    cur[i] = static_cast<uint8_t>(row[i] + (up ? up[i] : 0));
                break;
            case 3:  // Average
                for (long i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    cur[i] = static_cast<uint8_t>(row[i] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (long i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    const int c = (up && i >= bpp) ? up[i - bpp] : 0;
                    cur[i] = static_cast<uint8_t>(row[i] + paeth(a, b, c));
                }
                break;
            default:
                return y + 1;
        }
    }
    return 0;
}
