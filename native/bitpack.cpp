// Native bit-packing for the compressed stream.
//
// Host-side runtime component: the reference keeps its
// whole runtime in C++ (SURVEY.md L0/C17); here only the host-bound codec hot
// path is native — packing/unpacking millions of variable-width integer
// fields per 4K frame, which is branchy bit twiddling Python/numpy does with
// multiple large temporaries.  Exposed through a C ABI and loaded with
// ctypes (no pybind11 dependency); the numpy implementation remains as a
// fallback and as the oracle in tests.
//
// Bit layout contract (must match codec/bitstream.py): per item, MSB-first
// within the stream: valid(1) | domain(d_bits) | transform(t_bits) |
// s_q(s_bits) | o_q(o_bits).  Items are concatenated without padding; the
// final byte is zero-padded.

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <vector>

namespace {

struct BitWriter {
    uint8_t* out;
    size_t bitpos = 0;
    void put(uint64_t value, unsigned width) {
        // MSB-first: highest bit of the field lands first.
        for (int b = static_cast<int>(width) - 1; b >= 0; --b) {
            const uint64_t bit = (value >> b) & 1u;
            const size_t byte = bitpos >> 3;
            const unsigned off = 7u - (bitpos & 7u);
            out[byte] = static_cast<uint8_t>(out[byte] | (bit << off));
            ++bitpos;
        }
    }
};

struct BitReader {
    const uint8_t* in;
    size_t bitpos = 0;
    uint64_t get(unsigned width) {
        uint64_t v = 0;
        for (unsigned i = 0; i < width; ++i) {
            const size_t byte = bitpos >> 3;
            const unsigned off = 7u - (bitpos & 7u);
            v = (v << 1) | ((in[byte] >> off) & 1u);
            ++bitpos;
        }
        return v;
    }
};

// ---------------------------------------------------------------------------
// Adaptive binary range coder with bit-tree symbol models (the classic
// LZMA-style coder, written from the textbook construction): 11-bit
// adaptive probabilities, shift-5 updates, 32-bit range with byte-wise
// renormalization and carry handling through a cache byte.  Used by
// codec/entropy.py as stream mode 2 — table-free (the model adapts), and a
// JOINT alphabet for the domain-index field recovers the ~0.7 bits/item the
// byte-planar split loses.  The numpy implementation in codec/entropy.py is
// the oracle; layouts must match it bit-for-bit.

constexpr unsigned kProbBits = 11;
constexpr uint16_t kProbInit = 1 << (kProbBits - 1);  // 1024
constexpr unsigned kMoveBits = 5;
constexpr uint32_t kTopValue = 1u << 24;

struct RangeEncoder {
    uint64_t low = 0;
    uint32_t range = 0xFFFFFFFFu;
    uint8_t cache = 0;
    uint64_t cache_size = 1;
    uint8_t* out;
    size_t cap;
    size_t pos = 0;
    bool overflow = false;

    void write_byte(uint8_t b) {
        if (pos < cap) out[pos++] = b;
        else overflow = true;
    }
    void shift_low() {
        if (static_cast<uint32_t>(low) < 0xFF000000u || (low >> 32) != 0) {
            uint8_t carry = static_cast<uint8_t>(low >> 32);
            uint8_t temp = cache;
            do {
                write_byte(static_cast<uint8_t>(temp + carry));
                temp = 0xFF;
            } while (--cache_size != 0);
            cache = static_cast<uint8_t>(low >> 24);
        }
        ++cache_size;
        low = (static_cast<uint32_t>(low)) << 8;
    }
    void encode_bit(uint16_t* prob, unsigned bit) {
        const uint32_t bound = (range >> kProbBits) * (*prob);
        if (!bit) {
            range = bound;
            *prob = static_cast<uint16_t>(
                *prob + (((1u << kProbBits) - *prob) >> kMoveBits));
        } else {
            low += bound;
            range -= bound;
            *prob = static_cast<uint16_t>(*prob - (*prob >> kMoveBits));
        }
        while (range < kTopValue) {
            range <<= 8;
            shift_low();
        }
    }
    void flush() {
        for (int i = 0; i < 5; ++i) shift_low();
    }
};

struct RangeDecoder {
    uint32_t range = 0xFFFFFFFFu;
    uint32_t code = 0;
    const uint8_t* in;
    size_t len;
    size_t pos = 0;
    bool underrun = false;

    uint8_t read_byte() {
        if (pos < len) return in[pos++];
        underrun = true;
        return 0;
    }
    void init() {
        read_byte();  // first emitted byte is always 0 (cache flush)
        for (int i = 0; i < 4; ++i) code = (code << 8) | read_byte();
    }
    unsigned decode_bit(uint16_t* prob) {
        const uint32_t bound = (range >> kProbBits) * (*prob);
        unsigned bit;
        if (code < bound) {
            bit = 0;
            range = bound;
            *prob = static_cast<uint16_t>(
                *prob + (((1u << kProbBits) - *prob) >> kMoveBits));
        } else {
            bit = 1;
            code -= bound;
            range -= bound;
            *prob = static_cast<uint16_t>(*prob - (*prob >> kMoveBits));
        }
        while (range < kTopValue) {
            range <<= 8;
            code = (code << 8) | read_byte();
        }
        return bit;
    }
};

}  // namespace

extern "C" {

// Bit-tree range encode of n values, nbits each (MSB-first tree walk).
// Returns the number of payload bytes written, or 0 if out_cap was too
// small (caller retries with a bigger buffer or falls back).
size_t ftc_rc_encode_tree(const uint32_t* vals, size_t n, unsigned nbits,
                          uint8_t* out, size_t out_cap) {
    if (nbits == 0 || nbits > 20) return 0;
    std::vector<uint16_t> probs(size_t(1) << nbits, kProbInit);
    RangeEncoder rc{};
    rc.out = out;
    rc.cap = out_cap;
    for (size_t i = 0; i < n; ++i) {
        const uint32_t v = vals[i];
        size_t m = 1;
        for (int b = static_cast<int>(nbits) - 1; b >= 0; --b) {
            const unsigned bit = (v >> b) & 1u;
            rc.encode_bit(&probs[m], bit);
            m = (m << 1) | bit;
            if (rc.overflow) return 0;
        }
    }
    rc.flush();
    if (rc.overflow) return 0;
    return rc.pos;
}

// Bit-tree range decode of n values, nbits each.  Returns 0 on success,
// nonzero when the payload ran out before n symbols were decoded (loud
// failure on truncation; trailing garbage after a valid prefix cannot be
// detected by an arithmetic coder and is the caller's length check).
int ftc_rc_decode_tree(const uint8_t* in, size_t in_len, unsigned nbits,
                       uint32_t* out, size_t n) {
    if (nbits == 0 || nbits > 20) return 2;
    std::vector<uint16_t> probs(size_t(1) << nbits, kProbInit);
    RangeDecoder rc{};
    rc.in = in;
    rc.len = in_len;
    rc.init();
    for (size_t i = 0; i < n; ++i) {
        size_t m = 1;
        for (unsigned b = 0; b < nbits; ++b) {
            m = (m << 1) | rc.decode_bit(&probs[m]);
        }
        out[i] = static_cast<uint32_t>(m - (size_t(1) << nbits));
        if (rc.underrun) return 1;
    }
    return 0;
}

// Returns the number of bytes written (caller sizes out as
// ceil(n*(1+d+t+s+o)/8) and zero-initializes it).
size_t ftc_pack_items(size_t n,
                      const uint32_t* dom, const uint32_t* tr,
                      const uint32_t* sq, const uint32_t* oq,
                      const uint8_t* valid,
                      unsigned d_bits, unsigned t_bits,
                      unsigned s_bits, unsigned o_bits,
                      uint8_t* out) {
    BitWriter w{out};
    for (size_t i = 0; i < n; ++i) {
        w.put(valid[i] ? 1u : 0u, 1);
        w.put(dom[i], d_bits);
        w.put(tr[i], t_bits);
        w.put(sq[i], s_bits);
        w.put(oq[i], o_bits);
    }
    return (w.bitpos + 7) >> 3;
}

void ftc_unpack_items(size_t n, const uint8_t* in,
                      unsigned d_bits, unsigned t_bits,
                      unsigned s_bits, unsigned o_bits,
                      uint32_t* dom, uint32_t* tr,
                      uint32_t* sq, uint32_t* oq, uint8_t* valid) {
    BitReader r{in};
    for (size_t i = 0; i < n; ++i) {
        valid[i] = static_cast<uint8_t>(r.get(1));
        dom[i] = static_cast<uint32_t>(r.get(d_bits));
        tr[i] = static_cast<uint32_t>(r.get(t_bits));
        sq[i] = static_cast<uint32_t>(r.get(s_bits));
        oq[i] = static_cast<uint32_t>(r.get(o_bits));
    }
}

// Canonical-Huffman symbol-serial decode (the entropy layer's host-bound
// loop; table layout must match codec/entropy.py::_decode_tables).
// Returns 0 on success, nonzero on a corrupt payload.
int ftc_huffman_decode(const uint8_t* payload, size_t n_payload,
                       size_t n_bits, const uint8_t* lengths,
                       uint8_t* out, size_t n_syms) {
    int counts[16] = {0};
    for (int s = 0; s < 256; ++s) {
        if (lengths[s] > 15) return 2;
        if (lengths[s]) counts[lengths[s]]++;
    }
    uint8_t symbols[256];
    int k = 0;
    for (int l = 1; l <= 15; ++l)
        for (int s = 0; s < 256; ++s)
            if (lengths[s] == l) symbols[k++] = static_cast<uint8_t>(s);
    int first_code[17];
    int first_index[17];
    int code = 0, idx = 0;
    for (int l = 1; l <= 15; ++l) {
        first_code[l] = code;
        first_index[l] = idx;
        code = (code + counts[l]) << 1;
        idx += counts[l];
    }
    if (n_bits > n_payload * 8) return 3;
    size_t pos = 0;
    for (size_t i = 0; i < n_syms; ++i) {
        int c = 0, l = 0;
        for (;;) {
            if (pos >= n_bits) return 1;
            const int bit = (payload[pos >> 3] >> (7u - (pos & 7u))) & 1;
            ++pos;
            c = (c << 1) | bit;
            ++l;
            if (l > 15) return 1;
            const int off = c - first_code[l];
            if (off >= 0 && off < counts[l]) {
                out[i] = symbols[first_index[l] + off];
                break;
            }
        }
    }
    return 0;
}

}  // extern "C"
