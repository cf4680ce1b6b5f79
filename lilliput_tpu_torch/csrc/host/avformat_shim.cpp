// Video/audio host stage (system ffmpeg): in-memory demux, codec probe,
// first-frame decode, keyframe index, and stateless raw-keyframe decode.
//
// TPU-native split of the reference's avcodec layer
// (/root/reference/avcodec.cpp): demux + H264/HEVC/VP8/VP9/AV1/MPEG4
// bitstream decode stay on host, but the `sws_scale` stage (pixel format
// conversion + colorspace matrix + scale, avcodec.cpp:37-111) is replaced
// by a fused device kernel — this shim exports raw YUV planes plus
// colorspace metadata, and lilliput_tpu/ops/color.py does the math on TPU.
// A host sws_scale fallback covers exotic pixel formats.
//
// Capability parity: SAR-corrected dimensions (:390-416), rotation metadata
// -> EXIF orientation (:418-463), codec/audio-codec names (:501-552),
// subtitle detection (:554-563), keyframe index for spritesheets (:651-723),
// codec parameters + extradata export (:728-767), and the stateless
// parallel-safe raw keyframe decoder (:774-873).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/display.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct AvDec {
    std::vector<uint8_t> data;
    size_t read_pos = 0;
    AVIOContext* avio = nullptr;
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    int video_stream = -1;
    int audio_stream = -1;
    AVFrame* frame = nullptr;
    bool eof = false;
};

int read_cb(void* opaque, uint8_t* buf, int buf_size) {
    auto* d = static_cast<AvDec*>(opaque);
    const size_t remain = d->data.size() - d->read_pos;
    if (remain == 0) return AVERROR_EOF;
    const size_t n = remain < static_cast<size_t>(buf_size) ? remain : buf_size;
    std::memcpy(buf, d->data.data() + d->read_pos, n);
    d->read_pos += n;
    return static_cast<int>(n);
}

int64_t seek_cb(void* opaque, int64_t offset, int whence) {
    auto* d = static_cast<AvDec*>(opaque);
    if (whence & AVSEEK_SIZE) return static_cast<int64_t>(d->data.size());
    whence &= ~AVSEEK_FORCE;
    int64_t pos = offset;
    if (whence == SEEK_CUR) pos += static_cast<int64_t>(d->read_pos);
    if (whence == SEEK_END) pos += static_cast<int64_t>(d->data.size());
    if (pos < 0 || pos > static_cast<int64_t>(d->data.size())) return -1;
    d->read_pos = static_cast<size_t>(pos);
    return pos;
}

// codec name enums shared with Python (codecs/video.py)
enum { kCodecUnknown = 0, kCodecH264, kCodecHEVC, kCodecAV1, kCodecVP8,
       kCodecVP9, kCodecMPEG4 };
enum { kAudioUnknown = 0, kAudioAAC, kAudioMP3, kAudioFLAC, kAudioVorbis,
       kAudioOpus };

int video_codec_enum(AVCodecID id) {
    switch (id) {
        case AV_CODEC_ID_H264: return kCodecH264;
        case AV_CODEC_ID_HEVC: return kCodecHEVC;
        case AV_CODEC_ID_AV1: return kCodecAV1;
        case AV_CODEC_ID_VP8: return kCodecVP8;
        case AV_CODEC_ID_VP9: return kCodecVP9;
        case AV_CODEC_ID_MPEG4: return kCodecMPEG4;
        default: return kCodecUnknown;
    }
}

int audio_codec_enum(AVCodecID id) {
    switch (id) {
        case AV_CODEC_ID_AAC: return kAudioAAC;
        case AV_CODEC_ID_MP3: return kAudioMP3;
        case AV_CODEC_ID_FLAC: return kAudioFLAC;
        case AV_CODEC_ID_VORBIS: return kAudioVorbis;
        case AV_CODEC_ID_OPUS: return kAudioOpus;
        default: return kAudioUnknown;
    }
}

int rotation_to_orientation(double theta) {
    // clockwise rotation degrees -> EXIF orientation (avcodec.cpp:418-463)
    int t = static_cast<int>(theta);
    t = ((t % 360) + 360) % 360;
    if (t >= 45 && t < 135) return 6;   // 90
    if (t >= 135 && t < 225) return 3;  // 180
    if (t >= 225 && t < 315) return 8;  // 270
    return 1;
}

bool open_codec(AvDec* d, bool hevc_enabled, bool av1_enabled) {
    if (d->video_stream < 0) return true;  // audio-only is fine
    AVCodecParameters* par = d->fmt->streams[d->video_stream]->codecpar;
    if (par->codec_id == AV_CODEC_ID_HEVC && !hevc_enabled) return false;
    if (par->codec_id == AV_CODEC_ID_AV1 && !av1_enabled) return false;
    const AVCodec* dec = avcodec_find_decoder(par->codec_id);
    if (!dec) return false;
    d->codec = avcodec_alloc_context3(dec);
    if (!d->codec) return false;
    if (avcodec_parameters_to_context(d->codec, par) < 0) return false;
    if (avcodec_open2(d->codec, dec, nullptr) < 0) return false;
    d->frame = av_frame_alloc();
    return d->frame != nullptr;
}

}  // namespace

extern "C" {

struct lp_av_info {
    int32_t width, height;              // SAR-corrected display size
    int32_t orientation;                // EXIF code from rotation metadata
    int32_t video_codec, audio_codec;
    int32_t has_video, has_audio, has_subtitles;
    int64_t duration_us;
    int32_t colorspace, color_range;    // AVCOL_* of the video stream
    int32_t pix_fmt;
    int32_t frame_count_estimate;
    int32_t color_primaries;
};

void* lp_av_open(const uint8_t* buf, size_t len, int32_t hevc_enabled,
                 int32_t av1_enabled) {
    av_log_set_level(AV_LOG_ERROR);
    auto* d = new (std::nothrow) AvDec();
    if (!d) return nullptr;
    d->data.assign(buf, buf + len);
    constexpr int kIoBuf = 1 << 16;
    uint8_t* iobuf = static_cast<uint8_t*>(av_malloc(kIoBuf));
    d->avio = avio_alloc_context(iobuf, kIoBuf, 0, d, read_cb, nullptr, seek_cb);
    d->fmt = avformat_alloc_context();
    d->fmt->pb = d->avio;
    if (avformat_open_input(&d->fmt, nullptr, nullptr, nullptr) < 0) {
        avio_context_free(&d->avio);
        delete d;
        return nullptr;
    }
    if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
        avformat_close_input(&d->fmt);
        avio_context_free(&d->avio);
        delete d;
        return nullptr;
    }
    d->video_stream = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                          nullptr, 0);
    d->audio_stream = av_find_best_stream(d->fmt, AVMEDIA_TYPE_AUDIO, -1, -1,
                                          nullptr, 0);
    if (d->video_stream < 0 && d->audio_stream < 0) {
        avformat_close_input(&d->fmt);
        avio_context_free(&d->avio);
        delete d;
        return nullptr;
    }
    if (!open_codec(d, hevc_enabled != 0, av1_enabled != 0)) {
        avformat_close_input(&d->fmt);
        avio_context_free(&d->avio);
        delete d;
        return nullptr;
    }
    return d;
}

void lp_av_get_info(void* h, lp_av_info* out) {
    auto* d = static_cast<AvDec*>(h);
    std::memset(out, 0, sizeof(*out));
    out->duration_us = d->fmt->duration > 0 ? d->fmt->duration : 0;
    out->orientation = 1;
    for (unsigned i = 0; i < d->fmt->nb_streams; i++) {
        if (d->fmt->streams[i]->codecpar->codec_type == AVMEDIA_TYPE_SUBTITLE)
            out->has_subtitles = 1;
    }
    if (d->audio_stream >= 0) {
        out->has_audio = 1;
        out->audio_codec =
            audio_codec_enum(d->fmt->streams[d->audio_stream]->codecpar->codec_id);
    }
    if (d->video_stream >= 0) {
        AVStream* st = d->fmt->streams[d->video_stream];
        AVCodecParameters* par = st->codecpar;
        out->has_video = 1;
        out->video_codec = video_codec_enum(par->codec_id);
        // SAR-corrected display dimensions (avcodec.cpp:390-416)
        int w = par->width, hh = par->height;
        AVRational sar = par->sample_aspect_ratio;
        if (sar.num > 0 && sar.den > 0 && sar.num != sar.den) {
            if (sar.num > sar.den)
                w = static_cast<int>(w * av_q2d(sar) + 0.5);
            else
                hh = static_cast<int>(hh / av_q2d(sar) + 0.5);
        }
        out->width = w;
        out->height = hh;
        out->colorspace = par->color_space;
        out->color_range = par->color_range;
        out->color_primaries = par->color_primaries;
        out->pix_fmt = par->format;
        out->frame_count_estimate = static_cast<int32_t>(st->nb_frames);
        // the legacy per-stream "rotate" dictionary tag (old MOV files)
        // takes precedence over the display matrix, matching the
        // reference's order (avcodec.cpp:428-431): tag value is clockwise
        // degrees, used directly
        AVDictionaryEntry* rot_tag =
            av_dict_get(st->metadata, "rotate", nullptr, 0);
        if (rot_tag && rot_tag->value && rot_tag->value[0]) {
            // reference parity (avcodec.cpp:450-461): the tag value maps
            // ONLY on exactly 90/180/270; anything else (negative,
            // non-quadrant) stays upright — no normalization, no sectors
            switch (atoi(rot_tag->value)) {
                case 90: out->orientation = 6; break;
                case 180: out->orientation = 3; break;
                case 270: out->orientation = 8; break;
                default: break;
            }
        } else {
            size_t sd_size = 0;
            const uint8_t* sd = av_stream_get_side_data(
                st, AV_PKT_DATA_DISPLAYMATRIX, &sd_size);
            if (sd && sd_size >= 9 * 4) {
                double theta = av_display_rotation_get(
                    reinterpret_cast<const int32_t*>(sd));
                // av_display_rotation_get returns counterclockwise; negate
                out->orientation = rotation_to_orientation(-theta);
            }
        }
    }
}

// Decode the next video frame. 1 = frame ready, 0 = eof, <0 = error.
int lp_av_decode_frame(void* h) {
    auto* d = static_cast<AvDec*>(h);
    if (!d->codec || d->video_stream < 0) return -1;
    AVPacket* pkt = av_packet_alloc();
    int ret;
    while (true) {
        ret = avcodec_receive_frame(d->codec, d->frame);
        if (ret == 0) break;
        if (ret == AVERROR_EOF) {
            av_packet_free(&pkt);
            return 0;
        }
        if (ret != AVERROR(EAGAIN)) {
            av_packet_free(&pkt);
            return -2;
        }
        // need more input
        int rf = av_read_frame(d->fmt, pkt);
        if (rf < 0) {
            avcodec_send_packet(d->codec, nullptr);  // flush
            continue;
        }
        if (pkt->stream_index == d->video_stream)
            avcodec_send_packet(d->codec, pkt);
        av_packet_unref(pkt);
    }
    av_packet_free(&pkt);
    return 1;
}

// out8: w, h, pix_fmt, colorspace, color_range, plane_count, chroma_w, chroma_h
void lp_av_frame_info(void* h, int32_t* out8) {
    auto* d = static_cast<AvDec*>(h);
    const AVFrame* f = d->frame;
    out8[0] = f->width;
    out8[1] = f->height;
    out8[2] = f->format;
    out8[3] = f->colorspace;
    out8[4] = f->color_range;
    const AVPixFmtDescriptor* desc =
        av_pix_fmt_desc_get(static_cast<AVPixelFormat>(f->format));
    int planes = 0;
    for (int i = 0; i < AV_NUM_DATA_POINTERS; i++)
        if (f->data[i]) planes = i + 1;
    out8[5] = planes;
    out8[6] = desc ? AV_CEIL_RSHIFT(f->width, desc->log2_chroma_w) : f->width;
    out8[7] = desc ? AV_CEIL_RSHIFT(f->height, desc->log2_chroma_h) : f->height;
}

// copy plane `idx` rows into out (tight stride w bytes * bpp)
int lp_av_frame_plane(void* h, int32_t idx, uint8_t* out, int32_t row_bytes,
                      int32_t rows) {
    auto* d = static_cast<AvDec*>(h);
    const AVFrame* f = d->frame;
    if (idx >= AV_NUM_DATA_POINTERS || !f->data[idx]) return -1;
    for (int32_t y = 0; y < rows; y++)
        std::memcpy(out + static_cast<size_t>(y) * row_bytes,
                    f->data[idx] + static_cast<size_t>(y) * f->linesize[idx],
                    row_bytes);
    return 0;
}

// sws_scale fallback: convert current frame to tight BGRA
int lp_av_frame_bgra(void* h, uint8_t* out, int32_t w, int32_t hh) {
    auto* d = static_cast<AvDec*>(h);
    const AVFrame* f = d->frame;
    SwsContext* sws = sws_getContext(
        f->width, f->height, static_cast<AVPixelFormat>(f->format),
        w, hh, AV_PIX_FMT_BGRA, SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!sws) return -1;
    uint8_t* dst[4] = {out, nullptr, nullptr, nullptr};
    int dst_stride[4] = {w * 4, 0, 0, 0};
    sws_scale(sws, f->data, f->linesize, 0, f->height, dst, dst_stride);
    sws_freeContext(sws);
    return 0;
}

// keyframe index for spritesheet workflows (avcodec.cpp:651-723):
// out triplets (pts_ms, byte_offset, byte_size); returns count or -1.
long lp_av_keyframes(void* h, int64_t* out, long cap) {
    auto* d = static_cast<AvDec*>(h);
    if (d->video_stream < 0) return -1;
    AVStream* st = d->fmt->streams[d->video_stream];
    AVRational tb = st->time_base;
    long n = 0;
    const int nb = avformat_index_get_entries_count(st);
    for (int i = 0; i < nb; i++) {
        const AVIndexEntry* e = avformat_index_get_entry(st, i);
        if (!e || !(e->flags & AVINDEX_KEYFRAME)) continue;
        if (n < cap) {
            // microseconds; clamp negative initial DTS (B-frame shift) to 0
            int64_t ts = av_rescale_q(e->timestamp, tb, {1, 1000000});
            out[n * 3 + 0] = ts < 0 ? 0 : ts;
            out[n * 3 + 1] = e->pos;
            out[n * 3 + 2] = e->size;
        }
        n++;
    }
    return n;
}

// codec parameters for stateless raw decode (avcodec.cpp:728-767)
int lp_av_codec_params(void* h, int32_t* codec_id, uint8_t* extradata,
                       int32_t cap) {
    auto* d = static_cast<AvDec*>(h);
    if (d->video_stream < 0) return -1;
    AVCodecParameters* par = d->fmt->streams[d->video_stream]->codecpar;
    *codec_id = par->codec_id;
    if (par->extradata_size > cap) return -par->extradata_size;
    if (par->extradata_size > 0)
        std::memcpy(extradata, par->extradata, par->extradata_size);
    return par->extradata_size;
}

// Stateless keyframe decode: fresh codec context per call, safe for parallel
// use across threads (parity with avcodec.cpp:770-873). Returns 0 and fills
// out (tight BGRA dst_w*dst_h*4, bilinear sws) or <0 on error.
int lp_av_decode_raw_keyframe(int32_t codec_id, const uint8_t* extradata,
                              int32_t extradata_len, const uint8_t* pkt_data,
                              size_t pkt_len, uint8_t* out, int32_t dst_w,
                              int32_t dst_h) {
    if (extradata_len > 10240) return -1;  // extradata cap (avcodec.cpp:790)
    const AVCodec* dec = avcodec_find_decoder(static_cast<AVCodecID>(codec_id));
    if (!dec) return -2;
    AVCodecContext* ctx = avcodec_alloc_context3(dec);
    if (!ctx) return -3;
    if (extradata_len > 0) {
        ctx->extradata = static_cast<uint8_t*>(
            av_mallocz(extradata_len + AV_INPUT_BUFFER_PADDING_SIZE));
        std::memcpy(ctx->extradata, extradata, extradata_len);
        ctx->extradata_size = extradata_len;
    }
    int rc = -4;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    if (avcodec_open2(ctx, dec, nullptr) == 0) {
        pkt = av_packet_alloc();
        frame = av_frame_alloc();
        uint8_t* buf = static_cast<uint8_t*>(
            av_malloc(pkt_len + AV_INPUT_BUFFER_PADDING_SIZE));
        std::memcpy(buf, pkt_data, pkt_len);
        std::memset(buf + pkt_len, 0, AV_INPUT_BUFFER_PADDING_SIZE);
        av_packet_from_data(pkt, buf, static_cast<int>(pkt_len));
        pkt->flags |= AV_PKT_FLAG_KEY;
        if (avcodec_send_packet(ctx, pkt) == 0) {
            avcodec_send_packet(ctx, nullptr);  // flush
            if (avcodec_receive_frame(ctx, frame) == 0) {
                SwsContext* sws = sws_getContext(
                    frame->width, frame->height,
                    static_cast<AVPixelFormat>(frame->format),
                    dst_w, dst_h, AV_PIX_FMT_BGRA, SWS_BILINEAR,
                    nullptr, nullptr, nullptr);
                if (sws) {
                    uint8_t* dst[4] = {out, nullptr, nullptr, nullptr};
                    int ds[4] = {dst_w * 4, 0, 0, 0};
                    sws_scale(sws, frame->data, frame->linesize, 0,
                              frame->height, dst, ds);
                    sws_freeContext(sws);
                    rc = 0;
                }
            }
        }
    }
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    avcodec_free_context(&ctx);
    return rc;
}

// ---------------------------------------------------------------------------
// Stateless packet -> native-bit-depth planes (the 10-bit AVIF HDR path:
// lilliput_tpu/codecs/avif.py feeds AV1 OBU samples it extracted from the
// ISOBMFF here, and the device tone-maps the full-precision planes —
// replacing the reference's 8-bit-through-libavif route for this repo and
// matching its dav1d-backed depth, avif.cpp:88-199).
// ---------------------------------------------------------------------------

struct RawFrame {
    AVCodecContext* ctx = nullptr;
    AVFrame* frame = nullptr;
};

// Decode ONE coded frame. codec_name (e.g. "libdav1d") is preferred; falls
// back to the generic decoder for codec_id. Returns handle or null.
// out12: w, h, pix_fmt, colorspace, color_range, plane_count, chroma_w,
//        chroma_h, bit_depth, color_primaries, color_trc, bytes_per_sample
void* lp_av_raw_frame_decode(const char* codec_name, int32_t codec_id,
                             const uint8_t* extradata, int32_t extradata_len,
                             const uint8_t* pkt_data, size_t pkt_len,
                             int32_t* out12) {
    if (extradata_len > 10240) return nullptr;  // extradata cap
    const AVCodec* dec = nullptr;
    if (codec_name && codec_name[0])
        dec = avcodec_find_decoder_by_name(codec_name);
    if (!dec) dec = avcodec_find_decoder(static_cast<AVCodecID>(codec_id));
    if (!dec) return nullptr;
    auto* rf = new (std::nothrow) RawFrame();
    if (!rf) return nullptr;
    rf->ctx = avcodec_alloc_context3(dec);
    if (!rf->ctx) { delete rf; return nullptr; }
    if (extradata_len > 0) {
        rf->ctx->extradata = static_cast<uint8_t*>(
            av_mallocz(extradata_len + AV_INPUT_BUFFER_PADDING_SIZE));
        std::memcpy(rf->ctx->extradata, extradata, extradata_len);
        rf->ctx->extradata_size = extradata_len;
    }
    bool ok = false;
    if (avcodec_open2(rf->ctx, dec, nullptr) == 0) {
        AVPacket* pkt = av_packet_alloc();
        rf->frame = av_frame_alloc();
        uint8_t* buf = static_cast<uint8_t*>(
            av_malloc(pkt_len + AV_INPUT_BUFFER_PADDING_SIZE));
        std::memcpy(buf, pkt_data, pkt_len);
        std::memset(buf + pkt_len, 0, AV_INPUT_BUFFER_PADDING_SIZE);
        av_packet_from_data(pkt, buf, static_cast<int>(pkt_len));
        pkt->flags |= AV_PKT_FLAG_KEY;
        if (avcodec_send_packet(rf->ctx, pkt) == 0) {
            avcodec_send_packet(rf->ctx, nullptr);  // flush
            if (avcodec_receive_frame(rf->ctx, rf->frame) == 0) ok = true;
        }
        av_packet_free(&pkt);
    }
    if (!ok) {
        if (rf->frame) av_frame_free(&rf->frame);
        avcodec_free_context(&rf->ctx);
        delete rf;
        return nullptr;
    }
    const AVFrame* f = rf->frame;
    const AVPixFmtDescriptor* desc =
        av_pix_fmt_desc_get(static_cast<AVPixelFormat>(f->format));
    int planes = 0;
    for (int i = 0; i < AV_NUM_DATA_POINTERS; i++)
        if (f->data[i]) planes = i + 1;
    out12[0] = f->width;
    out12[1] = f->height;
    out12[2] = f->format;
    out12[3] = f->colorspace;
    out12[4] = f->color_range;
    out12[5] = planes;
    out12[6] = desc ? AV_CEIL_RSHIFT(f->width, desc->log2_chroma_w) : f->width;
    out12[7] = desc ? AV_CEIL_RSHIFT(f->height, desc->log2_chroma_h) : f->height;
    out12[8] = desc ? desc->comp[0].depth : 8;
    out12[9] = f->color_primaries;
    out12[10] = f->color_trc;
    out12[11] = desc && desc->comp[0].depth > 8 ? 2 : 1;
    return rf;
}

// Encode n_frames of tightly-packed planar pixels to AV1 OBU packets
// via libaom-av1 — the same encoder the reference drives through
// libavif (/root/reference/avif.cpp:614-776), with the same knobs:
// crf (libavif quality -> qp mapping done by the caller), cpu_used
// (speed), optional true-lossless mode, thread count, keyframe
// interval. fmt: 0 = yuv420p BT.601 studio, 1 = yuv444p BT.601
// studio, 2 = gray8 full range (monochrome AV1, used for alpha
// planes), 3 = yuv444p identity-matrix full range (lossless RGB: the
// caller passes G,B,R planes per the AV1 identity convention).
// planes: per frame Y then U then V (chroma dims per fmt), frames
// back to back. Packet data is concatenated into out with per-packet
// sizes in pkt_sizes. Returns the packet count, or <0 on failure.
//
// The _impl additionally takes depth (8/10/12 — planes become
// little-endian uint16 above 8), fmt 4 = yuv422p, and optional
// matrix/range overrides (AVCOL_SPC_* code / 0|1, -1 = keep the fmt
// default). The high-depth surface exists to synthesize >8-bit SDR
// fixtures for pinning the own AVIF decode against PIL/libavif
// (tests/test_avif.py); the product encode path stays 8-bit like the
// reference's (avif.cpp:614 takes 8-bit BGRA).
static long av1_encode_impl(const uint8_t* planes, int32_t w, int32_t h,
                            int32_t fmt, int32_t depth, int32_t matrix,
                            int32_t full_range, int32_t n_frames,
                            int32_t timescale, const int64_t* durations,
                            int32_t crf, int32_t cpu_used,
                            int32_t lossless, int32_t threads,
                            int32_t keyint, uint8_t* out,
                            int64_t out_cap, int64_t* pkt_sizes,
                            int32_t max_pkts) {
    if (w <= 0 || h <= 0 || n_frames <= 0 || timescale <= 0) return -1;
    if (depth != 8 && depth != 10 && depth != 12) return -1;
    const AVCodec* enc = avcodec_find_encoder_by_name("libaom-av1");
    if (!enc) return -2;
    AVCodecContext* ctx = avcodec_alloc_context3(enc);
    if (!ctx) return -3;
    ctx->width = w;
    ctx->height = h;
    static const AVPixelFormat kFmt[5][3] = {
        {AV_PIX_FMT_YUV420P, AV_PIX_FMT_YUV420P10LE, AV_PIX_FMT_YUV420P12LE},
        {AV_PIX_FMT_YUV444P, AV_PIX_FMT_YUV444P10LE, AV_PIX_FMT_YUV444P12LE},
        {AV_PIX_FMT_GRAY8, AV_PIX_FMT_GRAY10LE, AV_PIX_FMT_GRAY12LE},
        {AV_PIX_FMT_YUV444P, AV_PIX_FMT_YUV444P10LE, AV_PIX_FMT_YUV444P12LE},
        {AV_PIX_FMT_YUV422P, AV_PIX_FMT_YUV422P10LE, AV_PIX_FMT_YUV422P12LE},
    };
    if (fmt < 0 || fmt > 4) { avcodec_free_context(&ctx); return -1; }
    ctx->pix_fmt = kFmt[fmt][depth == 8 ? 0 : depth == 10 ? 1 : 2];
    ctx->time_base = {1, timescale};
    ctx->thread_count = threads > 0 ? threads : 1;
    ctx->gop_size = keyint > 0 ? keyint : n_frames;
    ctx->max_b_frames = 0;
    if (fmt == 3) {
        ctx->colorspace = AVCOL_SPC_RGB;          // identity (GBR)
        ctx->color_range = AVCOL_RANGE_JPEG;      // full range
    } else if (fmt == 2) {
        ctx->color_range = AVCOL_RANGE_JPEG;      // alpha is full range
    } else {
        ctx->colorspace = AVCOL_SPC_BT470BG;      // BT.601 matrix
        ctx->color_range = AVCOL_RANGE_MPEG;      // studio swing
    }
    if (matrix >= 0)
        ctx->colorspace = static_cast<AVColorSpace>(matrix);
    if (full_range >= 0)
        ctx->color_range = full_range ? AVCOL_RANGE_JPEG : AVCOL_RANGE_MPEG;
    av_opt_set_int(ctx->priv_data, "cpu-used",
                   cpu_used < 0 ? 6 : (cpu_used > 8 ? 8 : cpu_used), 0);
    if (lossless) {
        av_opt_set_int(ctx->priv_data, "lossless", 1, 0);
        av_opt_set_int(ctx->priv_data, "crf", 0, 0);
    } else {
        av_opt_set_int(ctx->priv_data, "crf",
                       crf < 0 ? 0 : (crf > 63 ? 63 : crf), 0);
        // rate control: constant quality, no bitrate target
        ctx->bit_rate = 0;
        av_opt_set(ctx->priv_data, "b", "0", 0);
    }
    if (avcodec_open2(ctx, enc, nullptr) != 0) {
        avcodec_free_context(&ctx);
        return -4;
    }
    const int bps = depth > 8 ? 2 : 1;
    const int cw = (fmt == 0 || fmt == 4) ? (w + 1) / 2 : w;
    const int ch = fmt == 0 ? (h + 1) / 2 : h;
    const size_t ysz = static_cast<size_t>(w) * h * bps;
    const size_t csz = static_cast<size_t>(cw) * ch * bps;
    const size_t frame_sz = fmt == 2 ? ysz : ysz + 2 * csz;
    AVFrame* frame = av_frame_alloc();
    AVPacket* pkt = av_packet_alloc();
    long npkts = 0;
    int64_t total = 0;
    int64_t pts = 0;
    bool fail = false;
    auto drain = [&](bool flush) {
        while (true) {
            int r = avcodec_receive_packet(ctx, pkt);
            if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
            if (r < 0) { fail = true; break; }
            if (npkts >= max_pkts || total + pkt->size > out_cap) {
                av_packet_unref(pkt);
                fail = true;
                break;
            }
            std::memcpy(out + total, pkt->data, pkt->size);
            pkt_sizes[npkts++] = pkt->size;
            total += pkt->size;
            av_packet_unref(pkt);
        }
        (void)flush;
    };
    for (int32_t i = 0; i < n_frames && !fail; i++) {
        frame->format = ctx->pix_fmt;
        frame->width = w;
        frame->height = h;
        if (av_frame_get_buffer(frame, 0) < 0) { fail = true; break; }
        const uint8_t* src = planes + static_cast<size_t>(i) * frame_sz;
        for (int y = 0; y < h; y++)
            std::memcpy(frame->data[0] + static_cast<size_t>(y) *
                        frame->linesize[0],
                        src + static_cast<size_t>(y) * w * bps,
                        static_cast<size_t>(w) * bps);
        if (fmt != 2) {
            for (int p = 1; p <= 2; p++) {
                const uint8_t* cs = src + ysz + (p - 1) * csz;
                for (int y = 0; y < ch; y++)
                    std::memcpy(frame->data[p] + static_cast<size_t>(y) *
                                frame->linesize[p],
                                cs + static_cast<size_t>(y) * cw * bps,
                                static_cast<size_t>(cw) * bps);
            }
        }
        frame->pts = pts;
        frame->pkt_duration = durations ? durations[i] : 1;
        pts += frame->pkt_duration;
        if (avcodec_send_frame(ctx, frame) < 0) fail = true;
        av_frame_unref(frame);
        drain(false);
    }
    if (!fail) {
        avcodec_send_frame(ctx, nullptr);
        drain(true);
    }
    av_frame_free(&frame);
    av_packet_free(&pkt);
    avcodec_free_context(&ctx);
    return fail ? -5 : npkts;
}

extern "C" long lp_av1_encode(const uint8_t* planes, int32_t w, int32_t h,
                              int32_t fmt, int32_t n_frames,
                              int32_t timescale, const int64_t* durations,
                              int32_t crf, int32_t cpu_used,
                              int32_t lossless, int32_t threads,
                              int32_t keyint, uint8_t* out,
                              int64_t out_cap, int64_t* pkt_sizes,
                              int32_t max_pkts) {
    return av1_encode_impl(planes, w, h, fmt, 8, -1, -1, n_frames,
                           timescale, durations, crf, cpu_used, lossless,
                           threads, keyint, out, out_cap, pkt_sizes,
                           max_pkts);
}

// Extended surface: depth 8/10/12, fmt 4 = yuv422p, matrix/full_range
// overrides (-1 = fmt default). Fixture generator for the >8-bit SDR
// decode pinning tests.
extern "C" long lp_av1_encode_hbd(const uint8_t* planes, int32_t w,
                                  int32_t h, int32_t fmt, int32_t depth,
                                  int32_t matrix, int32_t full_range,
                                  int32_t n_frames, int32_t timescale,
                                  const int64_t* durations, int32_t crf,
                                  int32_t cpu_used, int32_t lossless,
                                  int32_t threads, int32_t keyint,
                                  uint8_t* out, int64_t out_cap,
                                  int64_t* pkt_sizes, int32_t max_pkts) {
    return av1_encode_impl(planes, w, h, fmt, depth, matrix, full_range,
                           n_frames, timescale, durations, crf, cpu_used,
                           lossless, threads, keyint, out, out_cap,
                           pkt_sizes, max_pkts);
}

int lp_av_raw_frame_plane(void* h, int32_t idx, uint8_t* out,
                          int32_t row_bytes, int32_t rows);
void lp_av_raw_frame_free(void* h);

// ---------------------------------------------------------------------------
// Stateful raw stream decoder: open once, feed coded frames sequentially.
// AVIF animation samples are INTER-coded (each references prior frames),
// so the stateless one-shot decoder above cannot decode frame n alone;
// this keeps the codec context alive across samples (the own AVIF SDR
// animated path, reference parity with avif.cpp's avifDecoderNextImage).
// ---------------------------------------------------------------------------

void* lp_av_stream_open(const char* codec_name, const uint8_t* extradata,
                        int32_t extradata_len) {
    if (extradata_len > 10240) return nullptr;
    const AVCodec* dec = nullptr;
    if (codec_name && codec_name[0])
        dec = avcodec_find_decoder_by_name(codec_name);
    if (!dec) dec = avcodec_find_decoder(AV_CODEC_ID_AV1);
    if (!dec) return nullptr;
    auto* rf = new (std::nothrow) RawFrame();
    if (!rf) return nullptr;
    rf->ctx = avcodec_alloc_context3(dec);
    if (!rf->ctx) { delete rf; return nullptr; }
    if (extradata_len > 0) {
        rf->ctx->extradata = static_cast<uint8_t*>(
            av_mallocz(extradata_len + AV_INPUT_BUFFER_PADDING_SIZE));
        if (!rf->ctx->extradata) {
            avcodec_free_context(&rf->ctx);
            delete rf;
            return nullptr;
        }
        std::memcpy(rf->ctx->extradata, extradata, extradata_len);
        rf->ctx->extradata_size = extradata_len;
    }
    rf->ctx->thread_count = 1;  // sequential serving decode, no delay
    if (avcodec_open2(rf->ctx, dec, nullptr) != 0) {
        avcodec_free_context(&rf->ctx);
        delete rf;
        return nullptr;
    }
    rf->frame = av_frame_alloc();
    if (!rf->frame) {
        avcodec_free_context(&rf->ctx);
        delete rf;
        return nullptr;
    }
    return rf;
}

// Feed one coded sample (or null to flush) and try to receive one frame.
// Returns 0 = frame ready (out12 filled as in lp_av_raw_frame_decode;
// read planes with lp_av_stream_plane), 1 = decoder needs more input,
// 2 = end of stream, <0 = error.
int lp_av_stream_next(void* h, const uint8_t* pkt_data, size_t pkt_len,
                      int32_t* out12) {
    auto* rf = static_cast<RawFrame*>(h);
    bool have_frame = false;
    if (pkt_data && pkt_len > 0) {
        AVPacket* pkt = av_packet_alloc();
        if (!pkt) return -1;
        uint8_t* buf = static_cast<uint8_t*>(
            av_malloc(pkt_len + AV_INPUT_BUFFER_PADDING_SIZE));
        if (!buf) { av_packet_free(&pkt); return -1; }
        std::memcpy(buf, pkt_data, pkt_len);
        std::memset(buf + pkt_len, 0, AV_INPUT_BUFFER_PADDING_SIZE);
        if (av_packet_from_data(pkt, buf, static_cast<int>(pkt_len)) < 0) {
            av_free(buf);
            av_packet_free(&pkt);
            return -1;
        }
        int r = avcodec_send_packet(rf->ctx, pkt);
        if (r == AVERROR(EAGAIN)) {
            // Decoder output queue is full: drain the pending frame
            // FIRST, then re-send — dropping the packet here would lose
            // a coded frame (one temporal unit can yield >1 frame). The
            // drained frame is returned now; the re-sent packet's frame
            // surfaces on a later call, preserving FIFO order.
            av_frame_unref(rf->frame);
            if (avcodec_receive_frame(rf->ctx, rf->frame) < 0) {
                av_packet_free(&pkt);
                return -2;
            }
            have_frame = true;
            r = avcodec_send_packet(rf->ctx, pkt);
        }
        av_packet_free(&pkt);
        if (r < 0) return -2;
    } else {
        avcodec_send_packet(rf->ctx, nullptr);  // flush
    }
    if (!have_frame) {
        av_frame_unref(rf->frame);
        int r = avcodec_receive_frame(rf->ctx, rf->frame);
        if (r == AVERROR(EAGAIN)) return 1;
        if (r == AVERROR_EOF) return 2;
        if (r < 0) return -3;
    }
    const AVFrame* f = rf->frame;
    const AVPixFmtDescriptor* desc =
        av_pix_fmt_desc_get(static_cast<AVPixelFormat>(f->format));
    int planes = 0;
    for (int i = 0; i < AV_NUM_DATA_POINTERS; i++)
        if (f->data[i]) planes = i + 1;
    out12[0] = f->width;
    out12[1] = f->height;
    out12[2] = f->format;
    out12[3] = f->colorspace;
    out12[4] = f->color_range;
    out12[5] = planes;
    out12[6] = desc ? AV_CEIL_RSHIFT(f->width, desc->log2_chroma_w) : f->width;
    out12[7] = desc ? AV_CEIL_RSHIFT(f->height, desc->log2_chroma_h)
                    : f->height;
    out12[8] = desc ? desc->comp[0].depth : 8;
    out12[9] = f->color_primaries;
    out12[10] = f->color_trc;
    out12[11] = desc && desc->comp[0].depth > 8 ? 2 : 1;
    return 0;
}

int lp_av_stream_plane(void* h, int32_t idx, uint8_t* out, int32_t row_bytes,
                       int32_t rows) {
    return lp_av_raw_frame_plane(h, idx, out, row_bytes, rows);
}

void lp_av_stream_free(void* h) { lp_av_raw_frame_free(h); }

int lp_av_raw_frame_plane(void* h, int32_t idx, uint8_t* out,
                          int32_t row_bytes, int32_t rows) {
    auto* rf = static_cast<RawFrame*>(h);
    const AVFrame* f = rf->frame;
    if (idx >= AV_NUM_DATA_POINTERS || !f->data[idx]) return -1;
    for (int32_t y = 0; y < rows; y++)
        std::memcpy(out + static_cast<size_t>(y) * row_bytes,
                    f->data[idx] + static_cast<size_t>(y) * f->linesize[idx],
                    row_bytes);
    return 0;
}

void lp_av_raw_frame_free(void* h) {
    auto* rf = static_cast<RawFrame*>(h);
    if (rf->frame) av_frame_free(&rf->frame);
    if (rf->ctx) avcodec_free_context(&rf->ctx);
    delete rf;
}

// short container format name (e.g. "mov,mp4,m4a,3gp,3g2,mj2", "matroska,webm")
int lp_av_format_name(void* h, char* out, int32_t cap) {
    auto* d = static_cast<AvDec*>(h);
    const char* name = d->fmt && d->fmt->iformat ? d->fmt->iformat->name : "";
    const int32_t n = static_cast<int32_t>(std::strlen(name));
    if (n + 1 > cap) return -1;
    std::memcpy(out, name, n + 1);
    return n;
}

void lp_av_free(void* h) {
    auto* d = static_cast<AvDec*>(h);
    if (d->frame) av_frame_free(&d->frame);
    if (d->codec) avcodec_free_context(&d->codec);
    if (d->fmt) avformat_close_input(&d->fmt);
    if (d->avio) avio_context_free(&d->avio);
    delete d;
}

}  // extern "C"
