// JPEG host entropy stage.
//
// TPU-native split of the JPEG codec (SURVEY.md §7 step 3): the serial
// Huffman/arithmetic entropy coding runs here on the host via libjpeg-turbo,
// exchanging *quantized DCT coefficients* with the device. Everything dense
// (dequant, IDCT, chroma upsampling, YCbCr->BGR, and the encode-side fDCT,
// quantization, downsampling) runs on the TPU as batched matmul/elementwise
// kernels (lilliput_tpu/ops/jpeg_kernels.py).
//
// This replaces the reference's use of OpenCV's imgcodecs JPEG wrapper
// (/root/reference/opencv.cpp:93-188) where libjpeg performs the full
// decode on CPU; here the CPU only touches the bitstream.
//
// Plain C ABI (ctypes-friendly), no globals, safe for concurrent calls from
// multiple Python threads (each call owns its libjpeg structs).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <thread>
#include <vector>

#include <jpeglib.h>
#include <jerror.h>

extern "C" {

// ---------------------------------------------------------------------------
// error handling: convert libjpeg longjmp-style errors into return codes
// ---------------------------------------------------------------------------

struct lp_error_mgr {
    jpeg_error_mgr pub;
    jmp_buf jump;
    char msg[JMSG_LENGTH_MAX];
};

static void lp_error_exit(j_common_ptr cinfo) {
    lp_error_mgr* err = reinterpret_cast<lp_error_mgr*>(cinfo->err);
    (*cinfo->err->format_message)(cinfo, err->msg);
    longjmp(err->jump, 1);
}

static void lp_emit_message(j_common_ptr, int) {}  // silence warnings

// ---------------------------------------------------------------------------
// info struct shared with Python (keep in sync with codecs/jpeg.py)
// ---------------------------------------------------------------------------

#define LP_JPEG_MAX_COMPONENTS 4

struct lp_jpeg_info {
    int32_t width;
    int32_t height;
    int32_t num_components;
    int32_t progressive;
    int32_t icc_length;          // 0 when absent
    int32_t comp_h_samp[LP_JPEG_MAX_COMPONENTS];
    int32_t comp_v_samp[LP_JPEG_MAX_COMPONENTS];
    int32_t comp_quant_tbl[LP_JPEG_MAX_COMPONENTS];
    int32_t comp_blocks_w[LP_JPEG_MAX_COMPONENTS];  // width_in_blocks
    int32_t comp_blocks_h[LP_JPEG_MAX_COMPONENTS];  // height_in_blocks
    int32_t comp_downsampled_w[LP_JPEG_MAX_COMPONENTS];
    int32_t comp_downsampled_h[LP_JPEG_MAX_COMPONENTS];
    int32_t jpeg_color_space;    // JCS_* of the compressed data
    int32_t restart_interval;
};

// Parse header only. Returns 0 on success, negative on failure.
int lp_jpeg_get_info(const uint8_t* buf, size_t len, lp_jpeg_info* out) {
    jpeg_decompress_struct cinfo;
    lp_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = lp_error_exit;
    jerr.pub.emit_message = lp_emit_message;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
    jpeg_save_markers(&cinfo, JPEG_APP0 + 2, 0xFFFF);  // ICC
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    // jpeg_read_header does not fill comp block geometry; calc it.
    jpeg_calc_output_dimensions(&cinfo);

    std::memset(out, 0, sizeof(*out));
    out->width = static_cast<int32_t>(cinfo.image_width);
    out->height = static_cast<int32_t>(cinfo.image_height);
    out->num_components = cinfo.num_components;
    out->progressive = cinfo.progressive_mode ? 1 : 0;
    out->jpeg_color_space = cinfo.jpeg_color_space;
    out->restart_interval = static_cast<int32_t>(cinfo.restart_interval);
    if (cinfo.num_components > LP_JPEG_MAX_COMPONENTS) {
        jpeg_destroy_decompress(&cinfo);
        return -3;
    }
    int max_h = 1, max_v = 1;
    for (int c = 0; c < cinfo.num_components; c++) {
        if (cinfo.comp_info[c].h_samp_factor > max_h) max_h = cinfo.comp_info[c].h_samp_factor;
        if (cinfo.comp_info[c].v_samp_factor > max_v) max_v = cinfo.comp_info[c].v_samp_factor;
    }
    for (int c = 0; c < cinfo.num_components; c++) {
        jpeg_component_info* ci = &cinfo.comp_info[c];
        out->comp_h_samp[c] = ci->h_samp_factor;
        out->comp_v_samp[c] = ci->v_samp_factor;
        out->comp_quant_tbl[c] = ci->quant_tbl_no;
        // geometry as the coefficient arrays will be laid out
        long cw = (static_cast<long>(cinfo.image_width) * ci->h_samp_factor + (8L * max_h) - 1) / (8L * max_h);
        long ch = (static_cast<long>(cinfo.image_height) * ci->v_samp_factor + (8L * max_v) - 1) / (8L * max_v);
        out->comp_blocks_w[c] = static_cast<int32_t>(cw);
        out->comp_blocks_h[c] = static_cast<int32_t>(ch);
        out->comp_downsampled_w[c] =
            static_cast<int32_t>((static_cast<long>(cinfo.image_width) * ci->h_samp_factor + max_h - 1) / max_h);
        out->comp_downsampled_h[c] =
            static_cast<int32_t>((static_cast<long>(cinfo.image_height) * ci->v_samp_factor + max_v - 1) / max_v);
    }
    // ICC length (concatenated APP2 payload)
    JOCTET* icc_data = nullptr;
    unsigned int icc_len = 0;
    if (jpeg_read_icc_profile(&cinfo, &icc_data, &icc_len)) {
        out->icc_length = static_cast<int32_t>(icc_len);
        free(icc_data);
    }
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode quantized DCT coefficients.
//   coefs:   array of per-component pointers (int16, blocks_h*blocks_w*64 each)
//   qtables: uint16[NUM_QUANT_TBLS*64] = 4*64, natural (row-major) order
//   icc:     optional output buffer for ICC payload (icc_cap bytes)
// Returns 0 on success.
int lp_jpeg_decode_coefs(const uint8_t* buf, size_t len,
                         int16_t** coefs, uint16_t* qtables,
                         uint8_t* icc, int32_t icc_cap) {
    jpeg_decompress_struct cinfo;
    lp_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = lp_error_exit;
    jerr.pub.emit_message = lp_emit_message;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
    jpeg_save_markers(&cinfo, JPEG_APP0 + 2, 0xFFFF);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    jvirt_barray_ptr* barrays = jpeg_read_coefficients(&cinfo);
    if (!barrays) {
        jpeg_destroy_decompress(&cinfo);
        return -3;
    }
    for (int c = 0; c < cinfo.num_components && c < LP_JPEG_MAX_COMPONENTS; c++) {
        jpeg_component_info* ci = &cinfo.comp_info[c];
        const JDIMENSION bw = ci->width_in_blocks;
        const JDIMENSION bh = ci->height_in_blocks;
        int16_t* dst = coefs[c];
        for (JDIMENSION row = 0; row < bh; row++) {
            JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
                reinterpret_cast<j_common_ptr>(&cinfo), barrays[c], row, 1, FALSE);
            std::memcpy(dst + static_cast<size_t>(row) * bw * DCTSIZE2,
                        rows[0], sizeof(JCOEF) * bw * DCTSIZE2);
        }
    }
    // quant tables (zigzag stored in natural order inside libjpeg already)
    for (int t = 0; t < NUM_QUANT_TBLS; t++) {
        if (cinfo.quant_tbl_ptrs[t]) {
            for (int i = 0; i < DCTSIZE2; i++)
                qtables[t * DCTSIZE2 + i] = cinfo.quant_tbl_ptrs[t]->quantval[i];
        } else {
            std::memset(qtables + t * DCTSIZE2, 0, sizeof(uint16_t) * DCTSIZE2);
        }
    }
    if (icc && icc_cap > 0) {
        JOCTET* icc_data = nullptr;
        unsigned int icc_len = 0;
        if (jpeg_read_icc_profile(&cinfo, &icc_data, &icc_len)) {
            if (static_cast<int32_t>(icc_len) <= icc_cap)
                std::memcpy(icc, icc_data, icc_len);
            free(icc_data);
        }
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Entropy-encode quantized coefficients produced on device.
//   ncomp 1 (gray) or 3 (YCbCr). h_samp/v_samp per component.
//   coefs per component: int16[blocks_h*blocks_w*64] (natural order)
//   qtable_luma / qtable_chroma: uint16[64] natural order
//   progressive: emit progressive scan script
//   icc: optional ICC profile to embed
// Returns number of bytes written into out, or negative error.
long lp_jpeg_encode_coefs(int32_t width, int32_t height, int32_t ncomp,
                          const int32_t* h_samp, const int32_t* v_samp,
                          int16_t** coefs,
                          const uint16_t* qtable_luma, const uint16_t* qtable_chroma,
                          int32_t progressive, int32_t optimize,
                          int32_t restart_in_rows,
                          const uint8_t* icc, int32_t icc_len,
                          uint8_t* out, size_t out_cap) {
    jpeg_compress_struct cinfo;
    lp_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = lp_error_exit;
    jerr.pub.emit_message = lp_emit_message;

    // setjmp-clobber hazard: mem_out/mem_size are modified AFTER setjmp
    // (jpeg_mem_dest, and libjpeg's mem-dest growth frees + reallocates
    // the buffer through these), so the longjmp error path must re-read
    // them from MEMORY — a register-restored stale mem_out would be
    // double-freed. The const pointer below is set before setjmp and
    // never modified (well-defined after longjmp); the volatile read
    // through it forces the memory value.
    unsigned char* mem_out = nullptr;
    unsigned long mem_size = 0;
    unsigned char** const mem_out_ref = &mem_out;

    if (setjmp(jerr.jump)) {
        jpeg_destroy_compress(&cinfo);
        unsigned char* p =
            *const_cast<unsigned char* volatile*>(mem_out_ref);
        if (p) free(p);
        return -1;
    }
    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, &mem_out, &mem_size);

    cinfo.image_width = static_cast<JDIMENSION>(width);
    cinfo.image_height = static_cast<JDIMENSION>(height);
    cinfo.input_components = ncomp;
    cinfo.in_color_space = ncomp == 1 ? JCS_GRAYSCALE : JCS_YCbCr;
    jpeg_set_defaults(&cinfo);
    jpeg_set_colorspace(&cinfo, ncomp == 1 ? JCS_GRAYSCALE : JCS_YCbCr);

    // install the exact tables the device quantized with
    unsigned int ql[DCTSIZE2], qc[DCTSIZE2];
    for (int i = 0; i < DCTSIZE2; i++) {
        ql[i] = qtable_luma[i];
        qc[i] = ncomp > 1 ? qtable_chroma[i] : 0;
    }
    jpeg_add_quant_table(&cinfo, 0, ql, 100, FALSE);
    if (ncomp > 1) jpeg_add_quant_table(&cinfo, 1, qc, 100, FALSE);
    for (int c = 0; c < ncomp; c++) {
        cinfo.comp_info[c].h_samp_factor = h_samp[c];
        cinfo.comp_info[c].v_samp_factor = v_samp[c];
        cinfo.comp_info[c].quant_tbl_no = c == 0 ? 0 : 1;
    }
    if (progressive) jpeg_simple_progression(&cinfo);
    if (optimize) cinfo.optimize_coding = TRUE;
    // DRI restart markers every N MCU rows (IMWRITE_JPEG_RST_INTERVAL
    // parity with the reference's OpenCV encoder options); also what makes
    // lp_jpeg_decode_coefs_parallel able to split the scan
    if (restart_in_rows > 0) cinfo.restart_in_rows = restart_in_rows;

    // build virtual coefficient arrays and fill from device output
    jvirt_barray_ptr barrays[LP_JPEG_MAX_COMPONENTS];
    int max_h = 1, max_v = 1;
    for (int c = 0; c < ncomp; c++) {
        if (h_samp[c] > max_h) max_h = h_samp[c];
        if (v_samp[c] > max_v) max_v = v_samp[c];
    }
    for (int c = 0; c < ncomp; c++) {
        long bw = (static_cast<long>(width) * h_samp[c] + 8L * max_h - 1) / (8L * max_h);
        long bh = (static_cast<long>(height) * v_samp[c] + 8L * max_v - 1) / (8L * max_v);
        // round rows up to v_samp (MCU alignment) as libjpeg requires
        JDIMENSION arr_rows = static_cast<JDIMENSION>((bh + v_samp[c] - 1) / v_samp[c] * v_samp[c]);
        JDIMENSION arr_cols = static_cast<JDIMENSION>((bw + h_samp[c] - 1) / h_samp[c] * h_samp[c]);
        barrays[c] = (*cinfo.mem->request_virt_barray)(
            reinterpret_cast<j_common_ptr>(&cinfo), JPOOL_IMAGE, FALSE,
            arr_cols, arr_rows, static_cast<JDIMENSION>(v_samp[c]));
    }
    (*cinfo.mem->realize_virt_arrays)(reinterpret_cast<j_common_ptr>(&cinfo));
    for (int c = 0; c < ncomp; c++) {
        long bw = (static_cast<long>(width) * h_samp[c] + 8L * max_h - 1) / (8L * max_h);
        long bh = (static_cast<long>(height) * v_samp[c] + 8L * max_v - 1) / (8L * max_v);
        JDIMENSION arr_rows = static_cast<JDIMENSION>((bh + v_samp[c] - 1) / v_samp[c] * v_samp[c]);
        JDIMENSION arr_cols = static_cast<JDIMENSION>((bw + h_samp[c] - 1) / h_samp[c] * h_samp[c]);
        for (JDIMENSION row = 0; row < arr_rows; row++) {
            JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
                reinterpret_cast<j_common_ptr>(&cinfo), barrays[c], row, 1, TRUE);
            std::memset(rows[0], 0, sizeof(JBLOCK) * arr_cols);
            if (row < static_cast<JDIMENSION>(bh)) {
                std::memcpy(rows[0], coefs[c] + static_cast<size_t>(row) * bw * DCTSIZE2,
                            sizeof(JCOEF) * bw * DCTSIZE2);
            }
        }
    }

    jpeg_write_coefficients(&cinfo, barrays);
    if (icc && icc_len > 0)
        jpeg_write_icc_profile(&cinfo, icc, static_cast<unsigned int>(icc_len));
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);

    long written = static_cast<long>(mem_size);
    if (static_cast<size_t>(written) > out_cap) {
        free(mem_out);
        return -2;
    }
    std::memcpy(out, mem_out, mem_size);
    free(mem_out);
    return written;
}

// ---------------------------------------------------------------------------
// Restart-marker-parallel coefficient decode (SURVEY.md hard part #2;
// the same scan-slicing idea as GPU JPEG decoders, e.g. "Accelerating
// JPEG Decompression on GPUs", arXiv:2111.09219).
//
// A baseline single-scan JPEG with a DRI interval that is a whole number of
// MCU rows splits into independently decodable slices: each restart marker
// resets the bit buffer and DC predictors. Each worker gets a synthetic
// in-memory JPEG = original headers (SOF height patched to its slice) +
// its slice's entropy bytes (restart markers renumbered from RST0) + EOI,
// decoded with a private libjpeg instance into the right block-row offset
// of the shared output arrays. Returns 0 ok, -10 "not sliceable" (caller
// falls back to lp_jpeg_decode_coefs), other negatives on error.
// ---------------------------------------------------------------------------

namespace {

struct lp_markers {
    size_t sof_payload = 0;   // offset of SOF payload (precision byte)
    size_t scan_start = 0;    // first entropy byte after SOS header
    bool progressive = false;
};

int lp_find_markers(const uint8_t* buf, size_t len, lp_markers* out) {
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return -1;
    size_t p = 2;
    while (p + 4 <= len) {
        if (buf[p] != 0xFF) return -1;
        uint8_t m = buf[p + 1];
        if (m == 0xFF) { p++; continue; }                 // fill byte
        if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) { p += 2; continue; }
        size_t seglen = (static_cast<size_t>(buf[p + 2]) << 8) | buf[p + 3];
        if (seglen < 2 || p + 2 + seglen > len) return -1;
        if (m == 0xC0 || m == 0xC1) out->sof_payload = p + 4;
        else if (m == 0xC2) { out->sof_payload = p + 4; out->progressive = true; }
        else if (m == 0xDA) { out->scan_start = p + 2 + seglen; return 0; }
        p += 2 + seglen;
    }
    return -1;
}

// Decode one synthetic slice JPEG into coefs at the given MCU-row offset.
int lp_decode_slice(const uint8_t* sbuf, size_t slen, int16_t** coefs,
                    const int32_t* full_bw, const int32_t* full_bh,
                    const int32_t* v_samp, int32_t mcu_row0) {
    jpeg_decompress_struct cinfo;
    lp_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = lp_error_exit;
    jerr.pub.emit_message = lp_emit_message;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, sbuf, static_cast<unsigned long>(slen));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    jvirt_barray_ptr* barrays = jpeg_read_coefficients(&cinfo);
    if (!barrays) {
        jpeg_destroy_decompress(&cinfo);
        return -3;
    }
    for (int c = 0; c < cinfo.num_components && c < LP_JPEG_MAX_COMPONENTS; c++) {
        jpeg_component_info* ci = &cinfo.comp_info[c];
        const JDIMENSION bw = ci->width_in_blocks;
        const JDIMENSION bh = ci->height_in_blocks;
        if (static_cast<int32_t>(bw) != full_bw[c]) {
            jpeg_destroy_decompress(&cinfo);
            return -4;
        }
        const int32_t row0 = mcu_row0 * v_samp[c];
        int16_t* dst = coefs[c] + static_cast<size_t>(row0) * bw * DCTSIZE2;
        for (JDIMENSION row = 0; row < bh; row++) {
            if (row0 + static_cast<int32_t>(row) >= full_bh[c]) break;
            JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
                reinterpret_cast<j_common_ptr>(&cinfo), barrays[c], row, 1, FALSE);
            std::memcpy(dst + static_cast<size_t>(row) * bw * DCTSIZE2,
                        rows[0], sizeof(JCOEF) * bw * DCTSIZE2);
        }
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

}  // namespace

int lp_jpeg_decode_coefs_parallel(const uint8_t* buf, size_t len,
                                  int16_t** coefs, uint16_t* qtables,
                                  int32_t nthreads) {
    lp_jpeg_info info;
    int rc = lp_jpeg_get_info(buf, len, &info);
    if (rc != 0) return rc;
    if (info.progressive || info.restart_interval <= 0 ||
        info.num_components > LP_JPEG_MAX_COMPONENTS)
        return -10;
    int max_h = 1, max_v = 1;
    for (int c = 0; c < info.num_components; c++) {
        if (info.comp_h_samp[c] > max_h) max_h = info.comp_h_samp[c];
        if (info.comp_v_samp[c] > max_v) max_v = info.comp_v_samp[c];
    }
    const int32_t mcu_w = 8 * max_h, mcu_h = 8 * max_v;
    const int32_t mcus_per_row = (info.width + mcu_w - 1) / mcu_w;
    const int32_t total_mcu_rows = (info.height + mcu_h - 1) / mcu_h;
    if (info.restart_interval % mcus_per_row != 0) return -10;
    const int32_t rows_per_seg = info.restart_interval / mcus_per_row;

    lp_markers mk;
    if (lp_find_markers(buf, len, &mk) != 0 || mk.sof_payload == 0) return -10;

    // entropy-scan segment boundaries (offset of each 0xFF of an RST pair)
    std::vector<size_t> bounds;  // start offset of each segment
    bounds.push_back(mk.scan_start);
    size_t end = len;
    for (size_t p = mk.scan_start; p + 1 < len; p++) {
        if (buf[p] != 0xFF) continue;
        uint8_t m = buf[p + 1];
        if (m == 0x00 || m == 0xFF) { p++; continue; }      // stuffed/fill
        if (m >= 0xD0 && m <= 0xD7) { bounds.push_back(p + 2); p++; continue; }
        if (m == 0xD9) { end = p; break; }
        return -10;  // another scan/marker: not a single-scan baseline image
    }
    const size_t n_segs = bounds.size();
    const int32_t expect_segs = (total_mcu_rows + rows_per_seg - 1) / rows_per_seg;
    if (static_cast<int32_t>(n_segs) != expect_segs) return -10;

    // quant tables from the (shared) header
    {
        jpeg_decompress_struct cinfo;
        lp_error_mgr jerr;
        cinfo.err = jpeg_std_error(&jerr.pub);
        jerr.pub.error_exit = lp_error_exit;
        jerr.pub.emit_message = lp_emit_message;
        if (setjmp(jerr.jump)) { jpeg_destroy_decompress(&cinfo); return -2; }
        jpeg_create_decompress(&cinfo);
        jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
        jpeg_read_header(&cinfo, TRUE);
        for (int t = 0; t < NUM_QUANT_TBLS; t++) {
            if (cinfo.quant_tbl_ptrs[t]) {
                for (int i = 0; i < DCTSIZE2; i++)
                    qtables[t * DCTSIZE2 + i] = cinfo.quant_tbl_ptrs[t]->quantval[i];
            } else {
                std::memset(qtables + t * DCTSIZE2, 0, sizeof(uint16_t) * DCTSIZE2);
            }
        }
        jpeg_destroy_decompress(&cinfo);
    }

    if (nthreads < 1) nthreads = 1;
    if (nthreads > static_cast<int32_t>(n_segs)) nthreads = static_cast<int32_t>(n_segs);

    std::vector<int> rcs(nthreads, 0);
    std::vector<std::thread> workers;
    for (int w = 0; w < nthreads; w++) {
        const size_t s0 = n_segs * w / nthreads;
        const size_t s1 = n_segs * (w + 1) / nthreads;
        workers.emplace_back([&, w, s0, s1]() {
            const int32_t r0 = static_cast<int32_t>(s0) * rows_per_seg;
            const int32_t r1 = static_cast<int32_t>(s1) * rows_per_seg;
            const int32_t slice_rows =
                (r1 >= total_mcu_rows ? total_mcu_rows : r1) - r0;
            const int32_t slice_h =
                (r1 >= total_mcu_rows) ? info.height - r0 * mcu_h
                                       : slice_rows * mcu_h;
            // synthetic slice: headers + renumbered entropy slice + EOI
            std::vector<uint8_t> sb;
            sb.reserve(mk.scan_start + (bounds.back() - bounds[s0]) + 4);
            sb.insert(sb.end(), buf, buf + mk.scan_start);
            sb[mk.sof_payload + 1] = static_cast<uint8_t>((slice_h >> 8) & 0xFF);
            sb[mk.sof_payload + 2] = static_cast<uint8_t>(slice_h & 0xFF);
            for (size_t s = s0; s < s1; s++) {
                const size_t a = bounds[s];
                const size_t b = (s + 1 < n_segs) ? bounds[s + 1] - 2 : end;
                if (s > s0) {
                    sb.push_back(0xFF);
                    sb.push_back(static_cast<uint8_t>(0xD0 + ((s - s0 - 1) & 7)));
                }
                sb.insert(sb.end(), buf + a, buf + b);
            }
            sb.push_back(0xFF);
            sb.push_back(0xD9);
            rcs[w] = lp_decode_slice(sb.data(), sb.size(), coefs,
                                     info.comp_blocks_w, info.comp_blocks_h,
                                     info.comp_v_samp, r0);
        });
    }
    for (auto& t : workers) t.join();
    for (int r : rcs)
        if (r != 0) return r;
    return 0;
}

// Scale a base quant table by libjpeg quality semantics (quality 1..100).
void lp_jpeg_scale_qtable(const uint16_t* base, int32_t quality, int32_t force_baseline,
                          uint16_t* out) {
    long scale = jpeg_quality_scaling(quality);
    for (int i = 0; i < DCTSIZE2; i++) {
        long v = (static_cast<long>(base[i]) * scale + 50L) / 100L;
        if (v <= 0) v = 1;
        if (v > 32767) v = 32767;
        if (force_baseline && v > 255) v = 255;
        out[i] = static_cast<uint16_t>(v);
    }
}

}  // extern "C"
