// Baseline sequential JPEG (ITU-T T.81 process 1: 8-bit samples, Huffman
// coding) with IJG libjpeg's integer pipeline, so that an image encoded here
// has the bytes libjpeg (and libjpeg-turbo) writes for it with
// jpeg_set_quality(q, force_baseline=TRUE), the islow DCT and no Huffman
// optimization, and a file decoded here has the pixels libjpeg gives with
// the islow IDCT, fancy upsampling and RGB output.
//
// Encoder: RGB -> YCbCr (16-bit fixed-point tables), edge replication to the
// MCU, h2v1 / h2v2 downsampling with alternating bias, the islow forward DCT
// (13 constant bits, 2 pass bits), quantization (|x| + 4q) / 8q, dummy blocks
// at the right and bottom of a partial MCU, the Annex K Huffman tables, and
// the markers libjpeg writes (SOI, APP0 JFIF 1.01, DQT and DHT one segment a
// table, SOF0, SOS, EOI).
//
// Decoder: any baseline or extended-sequential Huffman file with 8-bit
// samples, 1 or 3 components, luma sampling 1x1, 2x1 or 2x2 over 1x1 chroma,
// interleaved or not, with restart intervals and any Huffman tables;
// progressive and arithmetic-coded files are refused.
//
// Plain C interface for ctypes (neural_imaging_tpu_torch/compression/
// baseline_jpeg.py, which also holds the plain numpy version of all of it).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag position -> natural (row-major) index
const int NATURAL[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1 quantization tables, natural order
const int STD_QUANT[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

// Annex K.3 Huffman tables: code counts by length 1..16, then the symbols
const uint8_t DC_LUMA_BITS[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t DC_CHROMA_BITS[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t AC_LUMA_BITS[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t AC_LUMA_VALS[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t AC_CHROMA_BITS[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t AC_CHROMA_VALS[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// fixed-point constants of the islow DCTs: FIX(x) = round(x * 2^13)
const int CONST_BITS = 13;
const int PASS1_BITS = 2;
const int64_t FIX_0_298631336 = 2446;
const int64_t FIX_0_390180644 = 3196;
const int64_t FIX_0_541196100 = 4433;
const int64_t FIX_0_765366865 = 6270;
const int64_t FIX_0_899976223 = 7373;
const int64_t FIX_1_175875602 = 9633;
const int64_t FIX_1_501321110 = 12299;
const int64_t FIX_1_847759065 = 15137;
const int64_t FIX_1_961570560 = 16069;
const int64_t FIX_2_053119869 = 16819;
const int64_t FIX_2_562915447 = 20995;
const int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// color conversion: 16 fraction bits, FIX(x) = round(x * 2^16)
const int SCALEBITS = 16;
const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
const int64_t CBCR_OFFSET = (int64_t)128 << SCALEBITS;
inline int64_t fix16(double x) { return (int64_t)(x * (1L << SCALEBITS) + 0.5); }

std::string g_error;
int g_code = -1;   // -1: bad input or a corrupt file; -2: a file this codec does not take

// ------------------------------------------------------------------------------
// Encoder
// ------------------------------------------------------------------------------

struct EncTable {
    uint16_t code[256];
    uint8_t size[256];
};

void derive_encoder_table(const uint8_t* bits, const uint8_t* vals, EncTable& t) {
    std::memset(t.size, 0, sizeof(t.size));
    uint32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; len++) {
        for (int i = 0; i < bits[len - 1]; i++, k++) {
            t.code[vals[k]] = (uint16_t)code++;
            t.size[vals[k]] = (uint8_t)len;
        }
        code <<= 1;
    }
}

struct BitWriter {
    std::vector<uint8_t>& out;
    uint32_t acc = 0;
    int n = 0;
    explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
    void put(uint32_t bits, int size) {
        if (size == 0) return;
        acc = (acc << size) | (bits & ((1u << size) - 1));
        n += size;
        while (n >= 8) {
            uint8_t byte = (uint8_t)(acc >> (n - 8));
            out.push_back(byte);
            if (byte == 0xFF) out.push_back(0);   // byte stuffing
            n -= 8;
        }
        acc &= (1u << n) - 1;
    }
    void flush() {   // pad the last byte with 1-bits
        put(0x7F, 7);
        acc = 0;
        n = 0;
    }
};

// islow forward DCT in place (output scaled by 8, as libjpeg's)
void fdct_islow(int64_t* d) {
    for (int pass = 0; pass < 2; pass++) {
        const int stride = pass == 0 ? 1 : 8;
        const int step = pass == 0 ? 8 : 1;
        for (int r = 0; r < 8; r++) {
            int64_t* p = d + r * step;
            int64_t tmp0 = p[0] + p[7 * stride], tmp7 = p[0] - p[7 * stride];
            int64_t tmp1 = p[stride] + p[6 * stride], tmp6 = p[stride] - p[6 * stride];
            int64_t tmp2 = p[2 * stride] + p[5 * stride], tmp5 = p[2 * stride] - p[5 * stride];
            int64_t tmp3 = p[3 * stride] + p[4 * stride], tmp4 = p[3 * stride] - p[4 * stride];
            int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            const int shift = pass == 0 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
            if (pass == 0) {
                p[0] = (tmp10 + tmp11) << PASS1_BITS;
                p[4 * stride] = (tmp10 - tmp11) << PASS1_BITS;
            } else {
                p[0] = descale(tmp10 + tmp11, PASS1_BITS);
                p[4 * stride] = descale(tmp10 - tmp11, PASS1_BITS);
            }
            int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
            p[2 * stride] = descale(z1 + tmp13 * FIX_0_765366865, shift);
            p[6 * stride] = descale(z1 - tmp12 * FIX_1_847759065, shift);
            z1 = tmp4 + tmp7;
            int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
            int64_t z5 = (z3 + z4) * FIX_1_175875602;
            tmp4 *= FIX_0_298631336;
            tmp5 *= FIX_2_053119869;
            tmp6 *= FIX_3_072711026;
            tmp7 *= FIX_1_501321110;
            z1 *= -FIX_0_899976223;
            z2 *= -FIX_2_562915447;
            z3 *= -FIX_1_961570560;
            z4 *= -FIX_0_390180644;
            z3 += z5;
            z4 += z5;
            p[7 * stride] = descale(tmp4 + z1 + z3, shift);
            p[5 * stride] = descale(tmp5 + z2 + z4, shift);
            p[3 * stride] = descale(tmp6 + z2 + z3, shift);
            p[stride] = descale(tmp7 + z1 + z4, shift);
        }
    }
}

void put_u16(std::vector<uint8_t>& o, int v) {
    o.push_back((uint8_t)(v >> 8));
    o.push_back((uint8_t)v);
}

void put_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits, const uint8_t* vals) {
    int n = 0;
    for (int i = 0; i < 16; i++) n += bits[i];
    put_u16(o, 0xFFC4);
    put_u16(o, 2 + 1 + 16 + n);
    o.push_back((uint8_t)cls_id);
    o.insert(o.end(), bits, bits + 16);
    o.insert(o.end(), vals, vals + n);
}

struct Component {
    int h, v;                // sampling factors
    int tq;                  // quantization table
    int bw, bh;              // blocks with data (width_in_blocks, height_in_blocks)
    int pw, ph;              // plane size in samples (MCU-aligned)
    std::vector<int32_t> plane;
};

// false if a coefficient is too large for baseline coding (DC > 11 bits, AC > 10)
bool encode_block(BitWriter& bw, const int16_t* blk, int& last_dc, const EncTable& dc,
                  const EncTable& ac) {
    int diff = blk[0] - last_dc;
    last_dc = blk[0];
    int t = diff < 0 ? -diff : diff;
    int t2 = diff < 0 ? diff - 1 : diff;
    int nbits = 0;
    while (t) { nbits++; t >>= 1; }
    if (nbits > 11) return false;
    bw.put(dc.code[nbits], dc.size[nbits]);
    bw.put((uint32_t)t2, nbits);
    int run = 0;
    for (int k = 1; k < 64; k++) {
        int c = blk[NATURAL[k]];
        if (c == 0) { run++; continue; }
        while (run > 15) {
            bw.put(ac.code[0xF0], ac.size[0xF0]);
            run -= 16;
        }
        int a = c < 0 ? -c : c;
        int a2 = c < 0 ? c - 1 : c;
        nbits = 0;
        while (a) { nbits++; a >>= 1; }
        if (nbits > 10) return false;
        int sym = (run << 4) + nbits;
        bw.put(ac.code[sym], ac.size[sym]);
        bw.put((uint32_t)a2, nbits);
        run = 0;
    }
    if (run > 0) bw.put(ac.code[0], ac.size[0]);
    return true;
}

bool encode(const uint8_t* rgb, int h, int w, int quality, int subsampling,
            std::vector<uint8_t>& out) {
    if (h < 1 || w < 1 || h > 65535 || w > 65535) { g_error = "image size out of range"; return false; }
    if (subsampling < 0 || subsampling > 2) { g_error = "subsampling must be 0, 1 or 2"; return false; }
    quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
    const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    int qt[2][64];
    for (int t = 0; t < 2; t++)
        for (int i = 0; i < 64; i++) {
            long q = ((long)STD_QUANT[t][i] * scale + 50L) / 100L;
            qt[t][i] = q < 1 ? 1 : (q > 255 ? 255 : (int)q);
        }

    const int hmax = subsampling == 0 ? 1 : 2, vmax = subsampling == 2 ? 2 : 1;
    const int mcux = (w + 8 * hmax - 1) / (8 * hmax), mcuy = (h + 8 * vmax - 1) / (8 * vmax);
    const int W = mcux * 8 * hmax, H = mcuy * 8 * vmax;

    // color conversion of the image replicated at its right and bottom edges
    int64_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
    for (int i = 0; i < 256; i++) {
        ry[i] = fix16(0.29900) * i;
        gy[i] = fix16(0.58700) * i;
        by[i] = fix16(0.11400) * i + ONE_HALF;
        rcb[i] = -fix16(0.16874) * i;
        gcb[i] = -fix16(0.33126) * i;
        bcb[i] = fix16(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;   // also R -> Cr
        gcr[i] = -fix16(0.41869) * i;
        bcr[i] = -fix16(0.08131) * i;
    }
    std::vector<int32_t> full[3];
    for (auto& f : full) f.resize((size_t)W * H);
    for (int y = 0; y < H; y++) {
        const uint8_t* row = rgb + (size_t)(y < h ? y : h - 1) * w * 3;
        for (int x = 0; x < W; x++) {
            const uint8_t* px = row + 3 * (x < w ? x : w - 1);
            const int r = px[0], g = px[1], b = px[2];
            const size_t o = (size_t)y * W + x;
            full[0][o] = (int32_t)((ry[r] + gy[g] + by[b]) >> SCALEBITS);
            full[1][o] = (int32_t)((rcb[r] + gcb[g] + bcb[b]) >> SCALEBITS);
            full[2][o] = (int32_t)((bcb[r] + gcr[g] + bcr[b]) >> SCALEBITS);
        }
    }

    Component comp[3];
    for (int c = 0; c < 3; c++) {
        Component& k = comp[c];
        k.h = c == 0 ? hmax : 1;
        k.v = c == 0 ? vmax : 1;
        k.tq = c == 0 ? 0 : 1;
        k.bw = (int)(((long)w * k.h + 8L * hmax - 1) / (8L * hmax));
        k.bh = (int)(((long)h * k.v + 8L * vmax - 1) / (8L * vmax));
        k.pw = W * k.h / hmax;
        k.ph = H * k.v / vmax;
        if (k.h == hmax && k.v == vmax) {
            k.plane.swap(full[c]);
            continue;
        }
        // h2v1 (bias 0,1,0,1,...) or h2v2 (bias 1,2,1,2,...) downsampling of
        // the rows that hold image data; below them the last such row repeats
        k.plane.resize((size_t)k.pw * k.ph);
        const std::vector<int32_t>& f = full[c];
        const int rows = (h + vmax - 1) / vmax;
        for (int y = 0; y < k.ph; y++) {
            if (y >= rows) {
                std::memcpy(&k.plane[(size_t)y * k.pw], &k.plane[(size_t)(rows - 1) * k.pw],
                            sizeof(int32_t) * k.pw);
                continue;
            }
            const int32_t* r0 = f.data() + (size_t)y * vmax * W;
            const int32_t* r1 = vmax == 2 ? r0 + W : r0;
            int bias = vmax == 2 ? 1 : 0;
            for (int x = 0; x < k.pw; x++) {
                int32_t s;
                if (vmax == 2) {
                    s = (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2;
                    bias ^= 3;
                } else {
                    s = (r0[2 * x] + r0[2 * x + 1] + bias) >> 1;
                    bias ^= 1;
                }
                k.plane[(size_t)y * k.pw + x] = s;
            }
        }
    }

    // headers
    out.clear();
    put_u16(out, 0xFFD8);
    const uint8_t app0[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01,
                            0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    out.insert(out.end(), app0, app0 + sizeof(app0));
    for (int t = 0; t < 2; t++) {
        put_u16(out, 0xFFDB);
        put_u16(out, 67);
        out.push_back((uint8_t)t);
        for (int k = 0; k < 64; k++) out.push_back((uint8_t)qt[t][NATURAL[k]]);
    }
    put_u16(out, 0xFFC0);
    put_u16(out, 17);
    out.push_back(8);
    put_u16(out, h);
    put_u16(out, w);
    out.push_back(3);
    for (int c = 0; c < 3; c++) {
        out.push_back((uint8_t)(c + 1));
        out.push_back((uint8_t)((comp[c].h << 4) | comp[c].v));
        out.push_back((uint8_t)comp[c].tq);
    }
    put_dht(out, 0x00, DC_LUMA_BITS, DC_VALS);
    put_dht(out, 0x10, AC_LUMA_BITS, AC_LUMA_VALS);
    put_dht(out, 0x01, DC_CHROMA_BITS, DC_VALS);
    put_dht(out, 0x11, AC_CHROMA_BITS, AC_CHROMA_VALS);
    const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02,
                           0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
    out.insert(out.end(), sos, sos + sizeof(sos));

    EncTable dc[2], ac[2];
    derive_encoder_table(DC_LUMA_BITS, DC_VALS, dc[0]);
    derive_encoder_table(AC_LUMA_BITS, AC_LUMA_VALS, ac[0]);
    derive_encoder_table(DC_CHROMA_BITS, DC_VALS, dc[1]);
    derive_encoder_table(AC_CHROMA_BITS, AC_CHROMA_VALS, ac[1]);

    BitWriter bw(out);
    int last_dc[3] = {0, 0, 0};
    int16_t mcu[4][64];
    int64_t work[64];
    for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
            for (int c = 0; c < 3; c++) {
                const Component& k = comp[c];
                const int* q = qt[k.tq];
                int n = 0;
                for (int yi = 0; yi < k.v; yi++) {
                    const int brow = my * k.v + yi;
                    for (int xi = 0; xi < k.h; xi++, n++) {
                        const int bcol = mx * k.h + xi;
                        int16_t* blk = mcu[n];
                        if (brow >= k.bh) {          // dummy row: DC of the block before
                            std::memset(blk, 0, sizeof(mcu[0]));
                            blk[0] = mcu[yi * k.h - 1][0];
                            continue;
                        }
                        if (bcol >= k.bw) {          // dummy column: DC of its left neighbor
                            std::memset(blk, 0, sizeof(mcu[0]));
                            blk[0] = mcu[n - 1][0];
                            continue;
                        }
                        for (int r = 0; r < 8; r++) {
                            const int32_t* src = k.plane.data() + (size_t)(brow * 8 + r) * k.pw + bcol * 8;
                            for (int s = 0; s < 8; s++) work[r * 8 + s] = src[s] - 128;
                        }
                        fdct_islow(work);
                        for (int i = 0; i < 64; i++) {
                            const int64_t d = 8 * q[i];
                            const int64_t t = work[i];
                            blk[i] = (int16_t)(t < 0 ? -((-t + d / 2) / d) : (t + d / 2) / d);
                        }
                    }
                }
                for (int b = 0; b < n; b++)
                    if (!encode_block(bw, mcu[b], last_dc[c], dc[k.tq], ac[k.tq])) {
                        g_error = "DCT coefficient out of range for baseline coding";
                        return false;
                    }
            }
        }
    }
    bw.flush();
    put_u16(out, 0xFFD9);
    return true;
}

// ------------------------------------------------------------------------------
// Decoder
// ------------------------------------------------------------------------------

struct DecTable {
    bool present = false;
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    int16_t look_sym[256];   // 8-bit lookahead: symbol, or -1
    uint8_t look_len[256];
};

bool derive_decoder_table(const uint8_t* bits, const uint8_t* vals, int nvals, DecTable& t) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int len = 1; len <= 16; len++)
        for (int i = 0; i < bits[len - 1]; i++) {
            if (p >= 256) return false;
            huffsize[p++] = len;
        }
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        if (code >= (1 << si)) return false;
        code <<= 1;
        si++;
    }
    p = 0;
    for (int len = 1; len <= 16; len++) {
        if (bits[len - 1]) {
            t.valoffset[len] = p - huffcode[p];
            p += bits[len - 1];
            t.maxcode[len] = huffcode[p - 1];
        } else {
            t.maxcode[len] = -1;
        }
    }
    t.maxcode[17] = 0x7FFFFFFF;
    std::memcpy(t.vals, vals, nvals);
    for (int i = 0; i < 256; i++) { t.look_sym[i] = -1; t.look_len[i] = 0; }
    p = 0;
    for (int len = 1; len <= 8; len++)
        for (int i = 0; i < bits[len - 1]; i++, p++) {
            int lookbits = huffcode[p] << (8 - len);
            for (int ctr = 1 << (8 - len); ctr > 0; ctr--, lookbits++) {
                t.look_sym[lookbits] = vals[p];
                t.look_len[lookbits] = (uint8_t)len;
            }
        }
    t.present = true;
    return true;
}

struct BitReader {
    const uint8_t* data;
    long len;
    long pos;
    uint64_t acc = 0;
    int nbits = 0;
    bool hit_marker = false;

    void fill() {
        while (nbits <= 56) {
            uint32_t byte = 0;
            if (!hit_marker && pos < len) {
                byte = data[pos];
                if (byte == 0xFF) {
                    long q = pos + 1;
                    while (q < len && data[q] == 0xFF) q++;   // fill bytes
                    if (q < len && data[q] == 0x00) {
                        pos = q + 1;
                    } else {
                        hit_marker = true;                    // leave the marker for the parser
                        pos = q - 1;
                        byte = 0;
                    }
                } else {
                    pos++;
                }
            }
            acc = (acc << 8) | byte;
            nbits += 8;
        }
    }
    inline int bits(int n) {
        if (n == 0) return 0;
        if (nbits < n) fill();
        nbits -= n;
        return (int)((acc >> nbits) & ((1ull << n) - 1));
    }
    inline int peek8() {
        if (nbits < 8) fill();
        return (int)((acc >> (nbits - 8)) & 0xFF);
    }
    // drop the buffered bits and step over the restart marker that follows
    bool restart() {
        acc = 0;
        nbits = 0;
        if (!hit_marker) {
            while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF)) pos++;
        }
        hit_marker = false;
        if (pos + 1 < len && data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) {
            pos += 2;
            return true;
        }
        return false;
    }
};

inline int decode_symbol(BitReader& br, const DecTable& t) {
    const int look = br.peek8();
    if (t.look_len[look]) {
        br.nbits -= t.look_len[look];
        return t.look_sym[look];
    }
    int code = br.bits(8);
    int len = 8;
    while (true) {
        len++;
        code = (code << 1) | br.bits(1);
        if (len > 16) return -1;
        if (code <= t.maxcode[len]) break;
    }
    return t.vals[(t.valoffset[len] + code) & 0xFF];
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct DecComp {
    int id, h, v, tq;
    int td = 0, ta = 0;
    int bw, bh;              // blocks of the component (width_in_blocks, height_in_blocks)
    int pbw, pbh;            // blocks allocated (MCU-aligned)
    std::vector<int16_t> coef;
};

// islow inverse DCT with libjpeg's wrapping range limit; out is 8x8 samples
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int64_t ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int64_t* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            const int64_t dc = ((int64_t)ip[0] * qp[0]) << PASS1_BITS;
            for (int r = 0; r < 8; r++) wp[8 * r] = dc;
            continue;
        }
        int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 - z3 * FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)ip[0] * qp[0];
        z3 = (int64_t)ip[32] * qp[32];
        int64_t tmp0 = (z2 + z3) << CONST_BITS, tmp1 = (z2 - z3) << CONST_BITS;
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = (int64_t)ip[56] * qp[56];
        tmp1 = (int64_t)ip[40] * qp[40];
        tmp2 = (int64_t)ip[24] * qp[24];
        tmp3 = (int64_t)ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int s = CONST_BITS - PASS1_BITS;
        wp[0] = descale(tmp10 + tmp3, s);
        wp[56] = descale(tmp10 - tmp3, s);
        wp[8] = descale(tmp11 + tmp2, s);
        wp[48] = descale(tmp11 - tmp2, s);
        wp[16] = descale(tmp12 + tmp1, s);
        wp[40] = descale(tmp12 - tmp1, s);
        wp[24] = descale(tmp13 + tmp0, s);
        wp[32] = descale(tmp13 - tmp0, s);
    }
    // range limit: (v & 1023) -> clamp(v + 128) for |v| < 512, wrapping beyond
    auto limit = [](int64_t v) -> uint8_t {
        const int i = (int)(v & 1023);
        if (i < 128) return (uint8_t)(i + 128);
        if (i < 512) return 255;
        if (i < 896) return 0;
        return (uint8_t)(i - 896);
    };
    const int s = CONST_BITS + PASS1_BITS + 3;
    for (int r = 0; r < 8; r++) {
        const int64_t* wp = ws + 8 * r;
        uint8_t* op = out + (size_t)r * stride;
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 - z3 * FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = (wp[0] + wp[4]) << CONST_BITS, tmp1 = (wp[0] - wp[4]) << CONST_BITS;
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        op[0] = limit(descale(tmp10 + tmp3, s));
        op[7] = limit(descale(tmp10 - tmp3, s));
        op[1] = limit(descale(tmp11 + tmp2, s));
        op[6] = limit(descale(tmp11 - tmp2, s));
        op[2] = limit(descale(tmp12 + tmp1, s));
        op[5] = limit(descale(tmp12 - tmp1, s));
        op[3] = limit(descale(tmp13 + tmp0, s));
        op[4] = limit(descale(tmp13 - tmp0, s));
    }
}

struct Decoder {
    const uint8_t* data;
    long len;
    long pos = 0;
    uint16_t qt[4][64];       // natural order
    bool qt_present[4] = {false, false, false, false};
    DecTable dc[4], ac[4];
    int height = 0, width = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    int restart_interval = 0;
    bool have_frame = false, saw_jfif = false, saw_adobe = false, done = false;
    int adobe_transform = 0;
    DecComp comp[3];

    bool fail(const char* msg) { g_error = msg; return false; }
    bool unsupported(const char* msg) { g_error = msg; g_code = -2; return false; }

    int u16(long p) const { return (data[p] << 8) | data[p + 1]; }

    bool parse_headers() {
        if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return fail("not a JPEG file: no SOI marker");
        pos = 2;
        while (true) {
            while (pos < len && data[pos] != 0xFF) pos++;        // skip garbage before a marker
            while (pos < len && data[pos] == 0xFF) pos++;
            if (pos >= len) return fail("unexpected end of file before the image data");
            const int m = data[pos++];
            if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
            if (m == 0xD9) return fail("EOI marker before the image data");
            if (pos + 2 > len) return fail("truncated marker segment");
            const int seglen = u16(pos);
            if (seglen < 2 || pos + seglen > len) return fail("truncated marker segment");
            const long p = pos + 2, end = pos + seglen;
            pos = end;
            if (m == 0xC0 || m == 0xC1) {
                if (!parse_sof(p, end)) return false;
            } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
                return unsupported("Progressive JPEG images are not supported");
            } else if (m == 0xC3 || m == 0xC5 || m == 0xC7 || (m >= 0xC9 && m <= 0xCF && m != 0xCC)) {
                return unsupported("only baseline / extended sequential Huffman JPEG files are supported");
            } else if (m == 0xC4) {
                if (!parse_dht(p, end)) return false;
            } else if (m == 0xDB) {
                if (!parse_dqt(p, end)) return false;
            } else if (m == 0xDD) {
                if (seglen != 4) return fail("bad DRI segment");
                restart_interval = u16(p);
            } else if (m == 0xDA) {
                if (!have_frame) return fail("SOS before SOF");
                if (!parse_sos_and_scan(p, end)) return false;
                if (done) return true;
            } else if (m == 0xE0) {
                if (end - p >= 5 && std::memcmp(data + p, "JFIF\0", 5) == 0) saw_jfif = true;
            } else if (m == 0xEE) {
                if (end - p >= 12 && std::memcmp(data + p, "Adobe", 5) == 0) {
                    saw_adobe = true;
                    adobe_transform = data[p + 11];
                }
            }
            // other APPn, COM, DNL: skipped
        }
    }

    bool parse_sof(long p, long end) {
        if (have_frame) return fail("more than one frame header");
        if (end - p < 6) return fail("bad SOF segment");
        if (data[p] != 8) return unsupported("only 8-bit JPEG files are supported");
        height = u16(p + 1);
        width = u16(p + 3);
        ncomp = data[p + 5];
        if (height < 1 || width < 1) return fail("image without rows or columns");
        if (ncomp != 1 && ncomp != 3) return unsupported("only 1- and 3-component JPEG files are supported");
        if (end - p < 6 + 3 * ncomp) return fail("bad SOF segment");
        hmax = vmax = 1;
        for (int c = 0; c < ncomp; c++) {
            DecComp& k = comp[c];
            k.id = data[p + 6 + 3 * c];
            k.h = data[p + 7 + 3 * c] >> 4;
            k.v = data[p + 7 + 3 * c] & 15;
            k.tq = data[p + 8 + 3 * c];
            if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) return fail("bad SOF component");
            hmax = k.h > hmax ? k.h : hmax;
            vmax = k.v > vmax ? k.v : vmax;
        }
        if (ncomp == 1) {
            comp[0].h = comp[0].v = hmax = vmax = 1;   // a lone component is never subsampled
        } else {
            for (int c = 1; c < 3; c++)
                if (comp[c].h != 1 || comp[c].v != 1) return unsupported("only 1x1 chroma sampling is supported");
            if (!((hmax == 1 && vmax == 1) || (hmax == 2 && vmax == 1) || (hmax == 2 && vmax == 2)))
                return unsupported("only 4:4:4, 4:2:2 and 4:2:0 sampling are supported");
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int c = 0; c < ncomp; c++) {
            DecComp& k = comp[c];
            k.bw = (int)(((long)width * k.h + 8L * hmax - 1) / (8L * hmax));
            k.bh = (int)(((long)height * k.v + 8L * vmax - 1) / (8L * vmax));
            k.pbw = mcux * k.h;
            k.pbh = mcuy * k.v;
            k.coef.assign((size_t)k.pbw * k.pbh * 64, 0);
        }
        have_frame = true;
        return true;
    }

    bool parse_dqt(long p, long end) {
        while (p < end) {
            const int pq = data[p] >> 4, tq = data[p] & 15;
            if (tq > 3 || pq > 1) return fail("bad DQT segment");
            if (end - p < 1 + 64 * (pq + 1)) return fail("bad DQT segment");
            for (int k = 0; k < 64; k++)
                qt[tq][NATURAL[k]] = pq ? (uint16_t)u16(p + 1 + 2 * k) : data[p + 1 + k];
            qt_present[tq] = true;
            p += 1 + 64 * (pq + 1);
        }
        return true;
    }

    bool parse_dht(long p, long end) {
        while (p < end) {
            if (end - p < 17) return fail("bad DHT segment");
            const int tc = data[p] >> 4, th = data[p] & 15;
            if (tc > 1 || th > 3) return fail("bad DHT segment");
            uint8_t bits[16];
            int n = 0;
            for (int i = 0; i < 16; i++) n += bits[i] = data[p + 1 + i];
            if (n > 256 || end - p < 17 + n) return fail("bad DHT segment");
            if (!derive_decoder_table(bits, data + p + 17, n, tc ? ac[th] : dc[th]))
                return fail("bad Huffman table");
            p += 17 + n;
        }
        return true;
    }

    bool decode_block(BitReader& br, DecComp& k, int16_t* blk, int& pred) {
        const DecTable& dct = dc[k.td];
        const DecTable& act = ac[k.ta];
        int s = decode_symbol(br, dct);
        if (s < 0 || s > 16) return fail("corrupt JPEG data: bad Huffman code");
        int diff = s ? extend(br.bits(s), s) : 0;
        pred += diff;
        blk[0] = (int16_t)pred;
        for (int k2 = 1; k2 < 64; k2++) {
            const int rs = decode_symbol(br, act);
            if (rs < 0) return fail("corrupt JPEG data: bad Huffman code");
            const int r = rs >> 4, sz = rs & 15;
            if (sz) {
                k2 += r;
                if (k2 > 63) break;
                blk[NATURAL[k2]] = (int16_t)extend(br.bits(sz), sz);
            } else {
                if (r != 15) break;
                k2 += 15;
            }
        }
        return true;
    }

    bool parse_sos_and_scan(long p, long end) {
        const int ns = data[p];
        if (ns < 1 || ns > ncomp || end - p < 4 + 2 * ns) return fail("bad SOS segment");
        DecComp* sc[3];
        for (int i = 0; i < ns; i++) {
            const int id = data[p + 1 + 2 * i];
            int c = 0;
            while (c < ncomp && comp[c].id != id) c++;
            if (c == ncomp) return fail("SOS names an unknown component");
            sc[i] = &comp[c];
            sc[i]->td = data[p + 2 + 2 * i] >> 4;
            sc[i]->ta = data[p + 2 + 2 * i] & 15;
            if (sc[i]->td > 3 || sc[i]->ta > 3 || !dc[sc[i]->td].present || !ac[sc[i]->ta].present)
                return fail("SOS names a missing Huffman table");
        }
        const int ss = data[p + 1 + 2 * ns], se = data[p + 2 + 2 * ns], ahal = data[p + 3 + 2 * ns];
        if (ss != 0 || se != 63 || ahal != 0) return fail("bad spectral selection for a sequential scan");

        BitReader br{data, len, pos};
        int pred[3] = {0, 0, 0};
        long n_mcu, per_row;
        if (ns == 1) {
            per_row = sc[0]->bw;
            n_mcu = (long)sc[0]->bw * sc[0]->bh;
        } else {
            per_row = mcux;
            n_mcu = (long)mcux * mcuy;
        }
        int to_restart = restart_interval;
        for (long m = 0; m < n_mcu; m++) {
            if (restart_interval) {
                if (to_restart == 0) {
                    br.restart();
                    pred[0] = pred[1] = pred[2] = 0;
                    to_restart = restart_interval;
                }
                to_restart--;
            }
            const long my = m / per_row, mx = m % per_row;
            if (ns == 1) {
                DecComp& k = *sc[0];
                if (!decode_block(br, k, &k.coef[((size_t)my * k.pbw + mx) * 64], pred[0])) return false;
                continue;
            }
            for (int i = 0; i < ns; i++) {
                DecComp& k = *sc[i];
                for (int yi = 0; yi < k.v; yi++)
                    for (int xi = 0; xi < k.h; xi++) {
                        const size_t b = (size_t)(my * k.v + yi) * k.pbw + mx * k.h + xi;
                        if (!decode_block(br, k, &k.coef[b * 64], pred[i])) return false;
                    }
            }
        }
        // continue after the scan's entropy-coded data
        pos = br.pos;
        while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                                  !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
            pos++;
        if (pos + 1 >= len || data[pos + 1] == 0xD9) done = true;
        return true;
    }

    bool to_rgb(uint8_t* out) {
        // inverse DCT of every block into each component's plane
        std::vector<uint8_t> plane[3];
        int pw[3], ph[3];
        for (int c = 0; c < ncomp; c++) {
            DecComp& k = comp[c];
            if (!qt_present[k.tq]) return fail("a component's quantization table is missing");
            pw[c] = k.pbw * 8;
            ph[c] = k.pbh * 8;
            plane[c].assign((size_t)pw[c] * ph[c], 0);
            for (int by = 0; by < k.pbh; by++)
                for (int bx = 0; bx < k.pbw; bx++)
                    idct_islow(&k.coef[((size_t)by * k.pbw + bx) * 64], qt[k.tq],
                               plane[c].data() + (size_t)by * 8 * pw[c] + bx * 8, pw[c]);
        }
        if (ncomp == 1) {
            for (int y = 0; y < height; y++)
                for (int x = 0; x < width; x++) {
                    const uint8_t v = plane[0][(size_t)y * pw[0] + x];
                    uint8_t* o = out + ((size_t)y * width + x) * 3;
                    o[0] = o[1] = o[2] = v;
                }
            return true;
        }
        // chroma upsampled to full size: fancy (triangle) filters, box when <= 2 wide
        std::vector<uint8_t> up[2];
        const int dw = (int)(((long)width + hmax - 1) / hmax);    // downsampled width
        const int dh = (int)(((long)height + vmax - 1) / vmax);
        for (int c = 1; c < 3; c++) {
            std::vector<uint8_t>& u = up[c - 1];
            u.assign((size_t)width * height, 0);
            const std::vector<uint8_t>& s = plane[c];
            const int sw = pw[c];
            if (hmax == 1) {
                for (int y = 0; y < height; y++)
                    std::memcpy(&u[(size_t)y * width], &s[(size_t)y * sw], width);
                continue;
            }
            std::vector<int> row(2 * (size_t)dw + 2);
            for (int y = 0; y < height; y++) {
                const int sy = y / vmax;
                if (dw <= 2) {                           // box upsampling
                    for (int x = 0; x < width; x++) u[(size_t)y * width + x] = s[(size_t)sy * sw + x / 2];
                    continue;
                }
                if (vmax == 1) {                         // h2v1 fancy
                    const uint8_t* in = &s[(size_t)sy * sw];
                    row[0] = in[0];
                    row[1] = (in[0] * 3 + in[1] + 2) >> 2;
                    for (int i = 1; i < dw - 1; i++) {
                        const int v = in[i] * 3;
                        row[2 * i] = (v + in[i - 1] + 1) >> 2;
                        row[2 * i + 1] = (v + in[i + 1] + 2) >> 2;
                    }
                    row[2 * (dw - 1)] = (in[dw - 1] * 3 + in[dw - 2] + 1) >> 2;
                    row[2 * (dw - 1) + 1] = in[dw - 1];
                } else {                                 // h2v2 fancy
                    const int ny = (y & 1) ? (sy + 1 < dh ? sy + 1 : dh - 1) : (sy > 0 ? sy - 1 : 0);
                    const uint8_t* in0 = &s[(size_t)sy * sw];
                    const uint8_t* in1 = &s[(size_t)ny * sw];
                    int thiscol = in0[0] * 3 + in1[0];
                    int nextcol = in0[1] * 3 + in1[1];
                    row[0] = (thiscol * 4 + 8) >> 4;
                    row[1] = (thiscol * 3 + nextcol + 7) >> 4;
                    int lastcol = thiscol;
                    thiscol = nextcol;
                    for (int i = 1; i < dw - 1; i++) {
                        nextcol = in0[i + 1] * 3 + in1[i + 1];
                        row[2 * i] = (thiscol * 3 + lastcol + 8) >> 4;
                        row[2 * i + 1] = (thiscol * 3 + nextcol + 7) >> 4;
                        lastcol = thiscol;
                        thiscol = nextcol;
                    }
                    row[2 * (dw - 1)] = (thiscol * 3 + lastcol + 8) >> 4;
                    row[2 * (dw - 1) + 1] = (thiscol * 4 + 7) >> 4;
                }
                for (int x = 0; x < width; x++) u[(size_t)y * width + x] = (uint8_t)row[x];
            }
        }
        // libjpeg's guess of the color space: JFIF means YCbCr, else Adobe's
        // transform flag, else component ids 'R', 'G', 'B' mean RGB
        const bool rgb = !saw_jfif && (saw_adobe ? adobe_transform == 0
                                                 : comp[0].id == 'R' && comp[1].id == 'G' &&
                                                       comp[2].id == 'B');
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        for (int i = 0; i < 256; i++) {
            const int64_t x = i - 128;
            cr_r[i] = (int)((fix16(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = (int)((fix16(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -fix16(0.71414) * x;
            cb_g[i] = -fix16(0.34414) * x + ONE_HALF;
        }
        auto clamp = [](int v) -> uint8_t { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
        for (int y = 0; y < height; y++)
            for (int x = 0; x < width; x++) {
                const int yy = plane[0][(size_t)y * pw[0] + x];
                const int cb = up[0][(size_t)y * width + x], cr = up[1][(size_t)y * width + x];
                uint8_t* o = out + ((size_t)y * width + x) * 3;
                if (rgb) {
                    o[0] = (uint8_t)yy;
                    o[1] = (uint8_t)cb;
                    o[2] = (uint8_t)cr;
                    continue;
                }
                o[0] = clamp(yy + cr_r[cr]);
                o[1] = clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
                o[2] = clamp(yy + cb_b[cb]);
            }
        return true;
    }
};

}  // namespace

extern "C" {

// Encode an (h, w, 3) uint8 RGB image. Returns the file's length and writes it
// into out when it fits in cap bytes; -1 on error (bj_error says why).
long bj_encode(const uint8_t* rgb, int h, int w, int quality, int subsampling, uint8_t* out,
               long cap) {
    std::vector<uint8_t> buf;
    buf.reserve((size_t)h * w + 1024);
    if (!encode(rgb, h, w, quality, subsampling, buf)) return -1;
    if ((long)buf.size() <= cap) std::memcpy(out, buf.data(), buf.size());
    return (long)buf.size();
}

// Read a file's frame header: height, width and component count; 0 on
// success, -1 on error.
int bj_decode_info(const uint8_t* data, long n, int* h, int* w, int* ncomp) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) {
        g_error = "not a JPEG file: no SOI marker";
        return -1;
    }
    long p = 2;
    while (p + 4 <= n) {
        while (p < n && data[p] != 0xFF) p++;
        while (p < n && data[p] == 0xFF) p++;
        if (p + 3 > n) break;
        const int m = data[p++];
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
        const int seglen = (data[p] << 8) | data[p + 1];
        if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || (m >= 0xC5 && m <= 0xCF && m != 0xC8 && m != 0xCC)) {
            if (p + 8 > n) break;
            *h = (data[p + 3] << 8) | data[p + 4];
            *w = (data[p + 5] << 8) | data[p + 6];
            *ncomp = data[p + 7];
            return 0;
        }
        if (m == 0xD9 || m == 0xDA) break;
        p += seglen;
    }
    g_error = "no frame header";
    return -1;
}

// Decode a file into an (h, w, 3) uint8 RGB image (grayscale replicated);
// 0 on success, -1 on a corrupt file, -2 on one this decoder does not take.
int bj_decode(const uint8_t* data, long n, uint8_t* out, int h, int w) {
    g_code = -1;
    Decoder d;
    d.data = data;
    d.len = n;
    if (!d.parse_headers()) return g_code;
    if (d.height != h || d.width != w) {
        g_error = "output size does not match the frame header";
        return -1;
    }
    return d.to_rgb(out) ? 0 : g_code;
}

const char* bj_error() { return g_error.c_str(); }

}  // extern "C"
