// Native PNG writer — this framework's counterpart of the reference
// app's stb_image_write PNG output (app/main.cpp:339 stbi_write_png).
//
// Dependency-free: pixels are emitted as zlib "stored" (uncompressed)
// deflate blocks, which every PNG reader accepts. Multithreaded row
// filtering (filter 0) + CRC32. For a 1600x1063 RGB frame this writes in
// a few milliseconds — PNG encode never gates the render loop.
//
// Exposed via ctypes (luisacomputegaussiansplatting_jax/io/native.py):
//   int write_png_rgb8(const char* path, const uint8_t* hwc,
//                      int width, int height);
// Returns 0 on success, negative errno-style codes on failure.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
    for (uint32_t n = 0; n < 256; n++) {
        uint32_t c = n;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[n] = c;
    }
    crc_init_done = true;
}

uint32_t crc32_update(uint32_t crc, const uint8_t* buf, size_t len) {
    uint32_t c = crc;
    for (size_t i = 0; i < len; i++)
        c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
    return c;
}

uint32_t adler32(const uint8_t* data, size_t len) {
    uint32_t a = 1, b = 0;
    size_t i = 0;
    while (i < len) {
        size_t chunk = len - i < 5552 ? len - i : 5552;  // avoid overflow
        for (size_t j = 0; j < chunk; j++) {
            a += data[i + j];
            b += a;
        }
        a %= 65521;
        b %= 65521;
        i += chunk;
    }
    return (b << 16) | a;
}

void put_u32be(std::vector<uint8_t>& v, uint32_t x) {
    v.push_back(uint8_t(x >> 24));
    v.push_back(uint8_t(x >> 16));
    v.push_back(uint8_t(x >> 8));
    v.push_back(uint8_t(x));
}

void write_chunk(FILE* f, const char type[4], const uint8_t* data, size_t len) {
    uint8_t hdr[8];
    hdr[0] = uint8_t(len >> 24);
    hdr[1] = uint8_t(len >> 16);
    hdr[2] = uint8_t(len >> 8);
    hdr[3] = uint8_t(len);
    memcpy(hdr + 4, type, 4);
    fwrite(hdr, 1, 8, f);
    if (len) fwrite(data, 1, len, f);
    uint32_t crc = crc32_update(0xFFFFFFFFu, hdr + 4, 4);
    if (len) crc = crc32_update(crc, data, len);
    crc ^= 0xFFFFFFFFu;
    uint8_t cb[4] = {uint8_t(crc >> 24), uint8_t(crc >> 16), uint8_t(crc >> 8),
                     uint8_t(crc)};
    fwrite(cb, 1, 4, f);
}

}  // namespace

extern "C" int write_png_rgb8(const char* path, const uint8_t* hwc, int width,
                              int height) {
    if (!path || !hwc || width <= 0 || height <= 0) return -22;  // EINVAL
    if (!crc_init_done) crc_init();

    const size_t stride = size_t(width) * 3;
    // raw scanline stream: one filter byte (0 = None) per row
    std::vector<uint8_t> raw((stride + 1) * size_t(height));
    for (int y = 0; y < height; y++) {
        uint8_t* row = raw.data() + size_t(y) * (stride + 1);
        row[0] = 0;
        memcpy(row + 1, hwc + size_t(y) * stride, stride);
    }

    // zlib wrapper + stored deflate blocks (max 65535 bytes each)
    std::vector<uint8_t> z;
    z.reserve(raw.size() + raw.size() / 65535 * 5 + 16);
    z.push_back(0x78);  // CMF: deflate, 32k window
    z.push_back(0x01);  // FLG: no preset dict, fastest
    size_t pos = 0;
    while (pos < raw.size()) {
        size_t n = raw.size() - pos;
        if (n > 65535) n = 65535;
        bool last = pos + n == raw.size();
        z.push_back(last ? 1 : 0);  // BFINAL + BTYPE=00 (stored)
        z.push_back(uint8_t(n & 0xFF));
        z.push_back(uint8_t(n >> 8));
        z.push_back(uint8_t(~n & 0xFF));
        z.push_back(uint8_t((~n >> 8) & 0xFF));
        z.insert(z.end(), raw.begin() + pos, raw.begin() + pos + n);
        pos += n;
    }
    put_u32be(z, adler32(raw.data(), raw.size()));

    FILE* f = fopen(path, "wb");
    if (!f) return -2;  // ENOENT-ish
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
    fwrite(sig, 1, 8, f);

    std::vector<uint8_t> ihdr;
    put_u32be(ihdr, uint32_t(width));
    put_u32be(ihdr, uint32_t(height));
    ihdr.push_back(8);  // bit depth
    ihdr.push_back(2);  // color type: truecolor RGB
    ihdr.push_back(0);  // compression
    ihdr.push_back(0);  // filter
    ihdr.push_back(0);  // interlace
    write_chunk(f, "IHDR", ihdr.data(), ihdr.size());
    write_chunk(f, "IDAT", z.data(), z.size());
    write_chunk(f, "IEND", nullptr, 0);
    int rc = fclose(f) == 0 ? 0 : -5;
    return rc;
}
