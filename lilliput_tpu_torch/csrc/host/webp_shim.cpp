// WebP host codec stage (system libwebp): container demux + VP8/VP8L
// entropy+prediction decode, animation encode.
//
// WebP's bitstream work is entropy/prediction-dominated (SURVEY.md §2.1 row
// "WebP decoder/encoder"), so like the reference it stays native; the frame
// transforms (blend/dispose compositing, resize) happen on device in
// ImageOps. Capability parity with /root/reference/webp.cpp:61-784:
// per-frame offsets/duration/dispose/blend, ICCP extraction/reattachment,
// still-vs-animation encode selection at flush, the 9 extended encode
// options (webp.hpp:13-23), and quality>100 => lossless.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <vector>

#include <webp/decode.h>
#include <webp/demux.h>
#include <webp/encode.h>
#include <webp/mux.h>

namespace {

struct WebpDec {
    std::vector<uint8_t> data;
    WebPData wdata{};
    WebPDemuxer* demux = nullptr;
    int frame_count = 0;
    int next_frame = 1;  // 1-indexed
    WebPIterator iter{};
    bool iter_valid = false;
    int channels = 4;
    int total_duration_ms = 0;
};

// encode option keys (parity with the reference's public constants)
enum {
    kWebpQuality = 64,   // cv::IMWRITE_WEBP_QUALITY
    kWebpMethod = 1000,
    kWebpFilterStrength = 1001,
    kWebpFilterType = 1002,
    kWebpAutofilter = 1003,
    kWebpPartitions = 1004,
    kWebpSegments = 1005,
    kWebpPreprocessing = 1006,
    kWebpThreadLevel = 1007,
    kWebpPalette = 1008,
};

void apply_opts(WebPConfig* config, const int32_t* opts, int32_t nopts) {
    for (int32_t i = 0; i + 1 < nopts; i += 2) {
        const int key = opts[i];
        const int value = opts[i + 1];
        switch (key) {
            case kWebpQuality: {
                float q = value < 1 ? 1.0f : static_cast<float>(value);
                config->quality = q > 100.0f ? 100.0f : q;
                config->lossless = q > 100.0f ? 1 : 0;
                break;
            }
            case kWebpMethod: config->method = value; break;
            case kWebpFilterStrength: config->filter_strength = value; break;
            case kWebpFilterType: config->filter_type = value; break;
            case kWebpAutofilter: config->autofilter = value; break;
            case kWebpPartitions: config->partitions = value; break;
            case kWebpSegments: config->segments = value; break;
            case kWebpPreprocessing: config->preprocessing = value; break;
            case kWebpThreadLevel: config->thread_level = value; break;
            case kWebpPalette: config->use_delta_palette = value; break;
        }
    }
}

struct WebpEnc {
    std::vector<uint8_t> icc;
    uint32_t bgcolor = 0;
    int loop_count = 0;
    int frames = 0;
    // first frame buffered until we know still-vs-animation
    std::vector<uint8_t> first_px;
    int first_w = 0, first_h = 0, first_ch = 4, first_delay = 0;
    std::vector<int32_t> first_opts;
    WebPAnimEncoder* anim = nullptr;
    int timestamp_ms = 0;
    // latched on a mid-migration add failure: the buffered-first-frame
    // state is gone, so further adds/flushes must fail instead of the
    // still path importing from the cleared first_px vector
    bool dead = false;
};

bool import_picture(WebPPicture* pic, const uint8_t* px, int w, int h, int ch,
                    bool use_argb) {
    pic->width = w;
    pic->height = h;
    pic->use_argb = use_argb ? 1 : 0;
    const int stride = w * ch;
    return ch == 4 ? WebPPictureImportBGRA(pic, px, stride)
                   : WebPPictureImportBGR(pic, px, stride);
}

bool anim_add(WebpEnc* e, const uint8_t* px, int w, int h, int ch,
              const int32_t* opts, int32_t nopts) {
    WebPConfig config;
    if (!WebPConfigPreset(&config, WEBP_PRESET_DEFAULT, 100.0f)) return false;
    apply_opts(&config, opts, nopts);
    WebPPicture pic;
    if (!WebPPictureInit(&pic)) return false;
    if (!import_picture(&pic, px, w, h, ch, config.lossless)) {
        WebPPictureFree(&pic);
        return false;
    }
    const bool ok = WebPAnimEncoderAdd(e->anim, &pic, e->timestamp_ms, &config) == 1;
    WebPPictureFree(&pic);
    return ok;
}

}  // namespace

extern "C" {

// out8: canvas_w, canvas_h, frame_count, loop_count, has_alpha, is_anim,
//       bgcolor, icc_len
void* lp_webp_open(const uint8_t* buf, size_t len, int32_t* out8) {
    auto* d = new (std::nothrow) WebpDec();
    if (!d) return nullptr;
    d->data.assign(buf, buf + len);
    d->wdata.bytes = d->data.data();
    d->wdata.size = d->data.size();
    d->demux = WebPDemux(&d->wdata);
    if (!d->demux) {
        delete d;
        return nullptr;
    }
    const uint32_t flags = WebPDemuxGetI(d->demux, WEBP_FF_FORMAT_FLAGS);
    out8[0] = static_cast<int32_t>(WebPDemuxGetI(d->demux, WEBP_FF_CANVAS_WIDTH));
    out8[1] = static_cast<int32_t>(WebPDemuxGetI(d->demux, WEBP_FF_CANVAS_HEIGHT));
    d->frame_count = static_cast<int>(WebPDemuxGetI(d->demux, WEBP_FF_FRAME_COUNT));
    out8[2] = d->frame_count;
    out8[3] = static_cast<int32_t>(WebPDemuxGetI(d->demux, WEBP_FF_LOOP_COUNT));
    const bool has_alpha = (flags & ALPHA_FLAG) || (flags & ANIMATION_FLAG);
    out8[4] = has_alpha ? 1 : 0;
    out8[5] = (flags & ANIMATION_FLAG) ? 1 : 0;
    out8[6] = static_cast<int32_t>(WebPDemuxGetI(d->demux, WEBP_FF_BACKGROUND_COLOR));
    d->channels = has_alpha ? 4 : 3;
    int32_t icc_len = 0;
    if (flags & ICCP_FLAG) {
        WebPChunkIterator it;
        if (WebPDemuxGetChunk(d->demux, "ICCP", 1, &it)) {
            icc_len = static_cast<int32_t>(it.chunk.size);
            WebPDemuxReleaseChunkIterator(&it);
        }
    }
    out8[7] = icc_len;
    // total animation duration (reference webp.cpp:107-112 sums every
    // frame's duration at open; still images sum to 0)
    d->total_duration_ms = 0;
    WebPIterator it;
    if (WebPDemuxGetFrame(d->demux, 1, &it)) {
        do {
            d->total_duration_ms += it.duration;
        } while (WebPDemuxNextFrame(&it));
        WebPDemuxReleaseIterator(&it);
    }
    return d;
}

// Total animation duration in ms (webp_decoder_get_total_duration parity,
// reference webp.cpp:251-254).
int lp_webp_total_duration(void* h) {
    return static_cast<WebpDec*>(h)->total_duration_ms;
}

int lp_webp_icc(void* h, uint8_t* out, int32_t cap) {
    auto* d = static_cast<WebpDec*>(h);
    WebPChunkIterator it;
    if (!WebPDemuxGetChunk(d->demux, "ICCP", 1, &it)) return 0;
    int32_t n = static_cast<int32_t>(it.chunk.size);
    if (n <= cap) std::memcpy(out, it.chunk.bytes, n);
    WebPDemuxReleaseChunkIterator(&it);
    return n <= cap ? n : -n;
}

// out8: x, y, w, h, duration_ms, dispose, blend, frame_has_alpha
int lp_webp_next_frame(void* h, int32_t* out8) {
    auto* d = static_cast<WebpDec*>(h);
    if (d->next_frame > d->frame_count) return 0;
    if (d->iter_valid) {
        WebPDemuxReleaseIterator(&d->iter);
        d->iter_valid = false;
    }
    if (!WebPDemuxGetFrame(d->demux, d->next_frame, &d->iter)) return -1;
    d->iter_valid = true;
    WebPBitstreamFeatures feat;
    if (WebPGetFeatures(d->iter.fragment.bytes, d->iter.fragment.size, &feat)
        != VP8_STATUS_OK) {
        return -1;
    }
    out8[0] = d->iter.x_offset;
    out8[1] = d->iter.y_offset;
    out8[2] = feat.width;
    out8[3] = feat.height;
    out8[4] = d->iter.duration;
    out8[5] = d->iter.dispose_method;   // 0 none, 1 background
    out8[6] = d->iter.blend_method;     // 0 blend (alpha), 1 no-blend
    out8[7] = feat.has_alpha;
    d->next_frame++;
    return 1;
}

// Decode the current frame fragment into out (w*h*channels, BGR(A)).
int lp_webp_frame_pixels(void* h, uint8_t* out, int32_t channels,
                         int32_t w, int32_t hgt) {
    auto* d = static_cast<WebpDec*>(h);
    if (!d->iter_valid) return -1;
    const size_t size = static_cast<size_t>(w) * hgt * channels;
    const int stride = w * channels;
    uint8_t* res = channels == 4
        ? WebPDecodeBGRAInto(d->iter.fragment.bytes, d->iter.fragment.size,
                             out, size, stride)
        : WebPDecodeBGRInto(d->iter.fragment.bytes, d->iter.fragment.size,
                            out, size, stride);
    return res ? 0 : -1;
}

void lp_webp_free(void* h) {
    auto* d = static_cast<WebpDec*>(h);
    if (d->iter_valid) WebPDemuxReleaseIterator(&d->iter);
    if (d->demux) WebPDemuxDelete(d->demux);
    delete d;
}

// ----------------------------- encoder ------------------------------------

void* lp_webp_enc_new(const uint8_t* icc, int32_t icc_len, uint32_t bgcolor,
                      int32_t loop_count) {
    auto* e = new (std::nothrow) WebpEnc();
    if (!e) return nullptr;
    if (icc && icc_len > 0) e->icc.assign(icc, icc + icc_len);
    e->bgcolor = bgcolor;
    e->loop_count = loop_count;
    return e;
}

int lp_webp_enc_add(void* h, const uint8_t* px, int32_t w, int32_t hgt,
                    int32_t channels, int32_t delay_ms,
                    const int32_t* opts, int32_t nopts) {
    auto* e = static_cast<WebpEnc*>(h);
    if (e->dead) return -1;
    if (e->frames == 0) {
        e->first_px.assign(px, px + static_cast<size_t>(w) * hgt * channels);
        e->first_w = w;
        e->first_h = hgt;
        e->first_ch = channels;
        e->first_delay = delay_ms;
        e->first_opts.assign(opts, opts + nopts);
        e->frames = 1;
        return 0;
    }
    if (e->frames == 1 && !e->anim) {
        // second frame arrived: this is an animation (the !anim guard
        // keeps a retried add from creating a second encoder — leaking
        // the first — or re-feeding the cleared first frame)
        WebPAnimEncoderOptions opt;
        if (!WebPAnimEncoderOptionsInit(&opt)) return -1;
        opt.kmin = 3;
        opt.kmax = 4;
        e->anim = WebPAnimEncoderNew(e->first_w, e->first_h, &opt);
        if (!e->anim) return -1;
        e->timestamp_ms = 0;
        if (!anim_add(e, e->first_px.data(), e->first_w, e->first_h, e->first_ch,
                      e->first_opts.data(), static_cast<int32_t>(e->first_opts.size()))) {
            e->dead = true;
            return -1;
        }
        e->timestamp_ms += e->first_delay;
        e->first_px.clear();
    }
    if (!anim_add(e, px, w, hgt, channels, opts, nopts)) {
        // the buffered first frame already migrated into the animation
        // encoder; this handle can no longer fall back to the still path
        e->dead = true;
        return -1;
    }
    e->timestamp_ms += delay_ms;
    e->frames++;
    return 0;
}

long lp_webp_enc_flush(void* h, const int32_t* opts, int32_t nopts,
                       uint8_t* out, size_t cap) {
    auto* e = static_cast<WebpEnc*>(h);
    WebPData assembled{nullptr, 0};
    bool ok = false;

    if (e->frames == 0 || e->dead) return -1;
    if (e->frames == 1) {
        // still image
        WebPConfig config;
        if (!WebPConfigPreset(&config, WEBP_PRESET_DEFAULT, 100.0f)) return -1;
        apply_opts(&config, e->first_opts.data(),
                   static_cast<int32_t>(e->first_opts.size()));
        apply_opts(&config, opts, nopts);
        WebPPicture pic;
        if (!WebPPictureInit(&pic)) return -1;
        WebPMemoryWriter wr;
        WebPMemoryWriterInit(&wr);
        pic.writer = WebPMemoryWrite;
        pic.custom_ptr = &wr;
        if (!import_picture(&pic, e->first_px.data(), e->first_w, e->first_h,
                            e->first_ch, config.lossless)) {
            WebPPictureFree(&pic);
            return -1;
        }
        ok = WebPEncode(&config, &pic) == 1;
        WebPPictureFree(&pic);
        if (!ok) {
            WebPMemoryWriterClear(&wr);
            return -1;
        }
        assembled.bytes = wr.mem;
        assembled.size = wr.size;
        // note: assembled now owns wr.mem; freed below via WebPDataClear-like free
    } else {
        // animation: closing empty frame fixes the last duration
        WebPConfig config;
        WebPConfigPreset(&config, WEBP_PRESET_DEFAULT, 100.0f);
        apply_opts(&config, opts, nopts);
        if (!WebPAnimEncoderAdd(e->anim, nullptr, e->timestamp_ms, &config)) return -1;
        if (!WebPAnimEncoderAssemble(e->anim, &assembled)) return -1;
        ok = true;
    }

    long result = -1;
    WebPMux* mux = WebPMuxCreate(&assembled, 0);
    if (mux) {
        if (!e->icc.empty()) {
            WebPData icc_data{e->icc.data(), e->icc.size()};
            WebPMuxSetChunk(mux, "ICCP", &icc_data, 1);
        }
        if (e->frames > 1) {
            WebPMuxAnimParams params{e->bgcolor, e->loop_count};
            WebPMuxSetAnimationParams(mux, &params);
        }
        WebPData final_data{nullptr, 0};
        if (WebPMuxAssemble(mux, &final_data) == WEBP_MUX_OK) {
            if (final_data.size <= cap) {
                std::memcpy(out, final_data.bytes, final_data.size);
                result = static_cast<long>(final_data.size);
            } else {
                result = -2;
            }
            WebPDataClear(&final_data);
        }
        WebPMuxDelete(mux);
    }
    WebPFree(const_cast<uint8_t*>(assembled.bytes));
    return ok ? result : -1;
}

void lp_webp_enc_free(void* h) {
    auto* e = static_cast<WebpEnc*>(h);
    if (e->anim) WebPAnimEncoderDelete(e->anim);
    delete e;
}

// Oracle for the device-side WebP YUV conversion: run libwebp's own lossy
// import (ImportYUVAFromRGBA — per-pixel fixed-point Y, gamma-corrected
// 2x2 chroma downsample) on BGRA/BGR pixels and export the planes.
// tests/test_webp.py gates ops/color.py:bgra_to_webp_yuv420 bit-exactly
// against this, which is what makes lp_webp_encode_yuv byte-identical to
// the BGRA encode path.
//   y: uint8[h*w]; u, v: uint8[ceil(h/2)*ceil(w/2)]; a: uint8[h*w] or null
//      (filled 255 when the source has no alpha plane)
int lp_webp_bgra_to_yuv(const uint8_t* px, int32_t w, int32_t h,
                        int32_t channels, uint8_t* y, uint8_t* u, uint8_t* v,
                        uint8_t* a) {
    WebPPicture pic;
    if (!WebPPictureInit(&pic)) return -1;
    if (!import_picture(&pic, px, w, h, channels, /*use_argb=*/false)) {
        WebPPictureFree(&pic);
        return -2;
    }
    const int uvw = (w + 1) / 2, uvh = (h + 1) / 2;
    for (int r = 0; r < h; r++)
        std::memcpy(y + static_cast<size_t>(r) * w,
                    pic.y + static_cast<size_t>(r) * pic.y_stride, w);
    for (int r = 0; r < uvh; r++) {
        std::memcpy(u + static_cast<size_t>(r) * uvw,
                    pic.u + static_cast<size_t>(r) * pic.uv_stride, uvw);
        std::memcpy(v + static_cast<size_t>(r) * uvw,
                    pic.v + static_cast<size_t>(r) * pic.uv_stride, uvw);
    }
    if (a) {
        if (pic.a)
            for (int r = 0; r < h; r++)
                std::memcpy(a + static_cast<size_t>(r) * w,
                            pic.a + static_cast<size_t>(r) * pic.a_stride, w);
        else
            std::memset(a, 255, static_cast<size_t>(w) * h);
    }
    WebPPictureFree(&pic);
    return 0;
}

// Still lossy encode straight from YUV420(A) planes (the device-converted
// serving fast path: 1.5 B/px over D2H instead of 4, and libwebp skips
// its import conversion). Byte-identical to the BGRA path because the
// planes are bit-identical to what the import would have produced (gated
// in tests). Lossless (quality>100) needs ARGB input — callers must
// route that through lp_webp_enc_add; this entry rejects it.
//   opts: (key, value) pairs as in lp_webp_enc_flush; icc optional.
// Returns bytes written to out (cap-limited), -2 if cap too small, -1 on
// failure, -3 if opts select lossless.
long lp_webp_encode_yuv(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                        const uint8_t* a, int32_t w, int32_t h,
                        const int32_t* opts, int32_t nopts,
                        const uint8_t* icc, int32_t icc_len, uint8_t* out,
                        size_t cap) {
    WebPConfig config;
    if (!WebPConfigPreset(&config, WEBP_PRESET_DEFAULT, 100.0f)) return -1;
    apply_opts(&config, opts, nopts);
    if (config.lossless) return -3;
    WebPPicture pic;
    if (!WebPPictureInit(&pic)) return -1;
    pic.width = w;
    pic.height = h;
    pic.use_argb = 0;
    pic.colorspace = a ? WEBP_YUV420A : WEBP_YUV420;
    if (!WebPPictureAlloc(&pic)) return -1;
    const int uvw = (w + 1) / 2, uvh = (h + 1) / 2;
    for (int r = 0; r < h; r++)
        std::memcpy(pic.y + static_cast<size_t>(r) * pic.y_stride,
                    y + static_cast<size_t>(r) * w, w);
    for (int r = 0; r < uvh; r++) {
        std::memcpy(pic.u + static_cast<size_t>(r) * pic.uv_stride,
                    u + static_cast<size_t>(r) * uvw, uvw);
        std::memcpy(pic.v + static_cast<size_t>(r) * pic.uv_stride,
                    v + static_cast<size_t>(r) * uvw, uvw);
    }
    if (a)
        for (int r = 0; r < h; r++)
            std::memcpy(pic.a + static_cast<size_t>(r) * pic.a_stride,
                        a + static_cast<size_t>(r) * w, w);
    WebPMemoryWriter wr;
    WebPMemoryWriterInit(&wr);
    pic.writer = WebPMemoryWrite;
    pic.custom_ptr = &wr;
    const bool ok = WebPEncode(&config, &pic) == 1;
    WebPPictureFree(&pic);
    if (!ok) {
        WebPMemoryWriterClear(&wr);
        return -1;
    }
    long result = -1;
    if (icc && icc_len > 0) {
        // remux with the ICC chunk, same as the flush path
        WebPData assembled{wr.mem, wr.size};
        WebPMux* mux = WebPMuxCreate(&assembled, 0);
        if (mux) {
            WebPData icc_data{icc, static_cast<size_t>(icc_len)};
            WebPMuxSetChunk(mux, "ICCP", &icc_data, 1);
            WebPData final_data{nullptr, 0};
            if (WebPMuxAssemble(mux, &final_data) == WEBP_MUX_OK) {
                if (final_data.size <= cap) {
                    std::memcpy(out, final_data.bytes, final_data.size);
                    result = static_cast<long>(final_data.size);
                } else {
                    result = -2;
                }
                WebPDataClear(&final_data);
            }
            WebPMuxDelete(mux);
        }
    } else if (wr.size <= cap) {
        std::memcpy(out, wr.mem, wr.size);
        result = static_cast<long>(wr.size);
    } else {
        result = -2;
    }
    WebPMemoryWriterClear(&wr);
    return result;
}

}  // extern "C"
