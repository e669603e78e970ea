// Native ingestion runtime: JPEG decode, Bayer demosaic, prefetching loader.
// A copy of ergo_uvo_tpu/io/native/decode.cpp for the PyTorch port.
//
// Replacement for the reference's host-side ingestion path:
// `from_ros_to_cv_image` (math_utility.cpp:154-173) decodes CompressedImage
// JPEGs via cv_bridge and demosaics "bayer*" formats (BGGR) to color; the ROS
// subscriber queue (visual_odometry.h:766-785) plays the role of the frame
// buffer.  Here the same roles are a small C++ library:
//   * eun_decode_jpeg   — libjpeg decompress to RGB8 or GRAY8;
//   * eun_demosaic_bggr — bilinear BGGR -> RGB8 (the reference's bayer case);
//   * eun_loader_*      — a multi-threaded file-decode prefetcher with a
//     bounded ring buffer (producer threads decode ahead of the consumer),
//     feeding fixed-shape frame arrays to the pipeline.
//
// Exposed with a plain C ABI for ctypes binding (no pybind11 in this image).

#include <cstdio>   // must precede jpeglib.h (it uses FILE unqualified)
#include <cstddef>

#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- JPEG decode

struct EunJpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

static void eun_jpeg_error_exit(j_common_ptr cinfo) {
  EunJpegErr* err = reinterpret_cast<EunJpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode a JPEG byte buffer.  out_channels: 1 = gray, 3 = RGB.
// Returns 0 on success; *out is malloc'd (caller frees with eun_free).
int eun_decode_jpeg(const uint8_t* data, size_t len, int out_channels,
                    uint8_t** out, int* width, int* height) {
  jpeg_decompress_struct cinfo;
  EunJpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = eun_jpeg_error_exit;
  uint8_t* buf = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = (out_channels == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int ch = cinfo.output_components;
  buf = static_cast<uint8_t*>(malloc(static_cast<size_t>(w) * h * ch));
  if (!buf) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf + static_cast<size_t>(cinfo.output_scanline) * w * ch;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buf;
  *width = w;
  *height = h;
  return 0;
}

void eun_free(uint8_t* p) { free(p); }

// ------------------------------------------------------------ Bayer demosaic

static inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Bilinear demosaic of a BGGR mosaic (the reference's "bayer" branch decodes
// BayerBG -> BGR; we emit RGB).  out must hold w*h*3 bytes.
int eun_demosaic_bggr(const uint8_t* bayer, int w, int h, uint8_t* out) {
  if (!bayer || !out || w < 2 || h < 2) return -1;
  auto at = [&](int y, int x) -> int {
    return bayer[static_cast<size_t>(clampi(y, 0, h - 1)) * w +
                 clampi(x, 0, w - 1)];
  };
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const bool even_row = (y % 2) == 0;
      const bool even_col = (x % 2) == 0;
      int r, g, b;
      if (even_row && even_col) {  // B site
        b = at(y, x);
        g = (at(y - 1, x) + at(y + 1, x) + at(y, x - 1) + at(y, x + 1)) / 4;
        r = (at(y - 1, x - 1) + at(y - 1, x + 1) + at(y + 1, x - 1) +
             at(y + 1, x + 1)) / 4;
      } else if (even_row && !even_col) {  // G site on B row
        g = at(y, x);
        b = (at(y, x - 1) + at(y, x + 1)) / 2;
        r = (at(y - 1, x) + at(y + 1, x)) / 2;
      } else if (!even_row && even_col) {  // G site on R row
        g = at(y, x);
        r = (at(y, x - 1) + at(y, x + 1)) / 2;
        b = (at(y - 1, x) + at(y + 1, x)) / 2;
      } else {  // R site
        r = at(y, x);
        g = (at(y - 1, x) + at(y + 1, x) + at(y, x - 1) + at(y, x + 1)) / 4;
        b = (at(y - 1, x - 1) + at(y - 1, x + 1) + at(y + 1, x - 1) +
             at(y + 1, x + 1)) / 4;
      }
      uint8_t* px = out + (static_cast<size_t>(y) * w + x) * 3;
      px[0] = static_cast<uint8_t>(r);
      px[1] = static_cast<uint8_t>(g);
      px[2] = static_cast<uint8_t>(b);
    }
  }
  return 0;
}

// --------------------------------------------------- prefetching file loader

struct EunFrame {
  int index;
  int w, h;
  std::vector<uint8_t> pixels;  // gray8 or rgb8
};

struct EunLoader {
  std::vector<std::string> paths;
  int channels;  // 1 or 3
  size_t capacity;
  std::atomic<size_t> next_job{0};
  std::deque<EunFrame> ring;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::vector<std::thread> workers;
  std::atomic<int> live_workers{0};
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      if (stop.load()) break;
      const size_t job = next_job.fetch_add(1);
      if (job >= paths.size()) break;
      EunFrame f;
      f.index = static_cast<int>(job);
      // Read the file.
      FILE* fp = fopen(paths[job].c_str(), "rb");
      if (!fp) continue;
      fseek(fp, 0, SEEK_END);
      const long len = ftell(fp);
      fseek(fp, 0, SEEK_SET);
      std::vector<uint8_t> raw(static_cast<size_t>(len));
      const size_t rd = fread(raw.data(), 1, raw.size(), fp);
      fclose(fp);
      if (rd != raw.size()) continue;
      uint8_t* px = nullptr;
      int w = 0, h = 0;
      if (eun_decode_jpeg(raw.data(), raw.size(), channels, &px, &w, &h) != 0) {
        continue;
      }
      f.w = w;
      f.h = h;
      f.pixels.assign(px, px + static_cast<size_t>(w) * h * channels);
      free(px);
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return ring.size() < capacity || stop.load(); });
        if (stop.load()) break;
        ring.push_back(std::move(f));
      }
      cv_pop.notify_one();
    }
    if (live_workers.fetch_sub(1) == 1) cv_pop.notify_all();
  }
};

void* eun_loader_create(const char** paths, int n, int threads, int capacity,
                        int channels) {
  EunLoader* L = new EunLoader();
  L->paths.assign(paths, paths + n);
  L->channels = channels;
  L->capacity = capacity > 0 ? capacity : 8;
  const int nt = threads > 0 ? threads : 2;
  L->live_workers = nt;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(&EunLoader::worker, L);
  return L;
}

// Pop the next decoded frame (any order — frames carry their index).
// out must hold max_bytes; returns bytes written, 0 when drained, -1 on error.
long eun_loader_next(void* loader, uint8_t* out, long max_bytes, int* index,
                     int* w, int* h) {
  EunLoader* L = static_cast<EunLoader*>(loader);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_pop.wait(lk, [&] {
    return !L->ring.empty() || L->live_workers.load() == 0 || L->stop.load();
  });
  if (L->ring.empty()) return 0;  // drained
  EunFrame f = std::move(L->ring.front());
  L->ring.pop_front();
  lk.unlock();
  L->cv_push.notify_one();
  const long bytes = static_cast<long>(f.pixels.size());
  if (bytes > max_bytes) return -1;
  memcpy(out, f.pixels.data(), static_cast<size_t>(bytes));
  *index = f.index;
  *w = f.w;
  *h = f.h;
  return bytes;
}

void eun_loader_destroy(void* loader) {
  EunLoader* L = static_cast<EunLoader*>(loader);
  L->stop.store(true);
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
