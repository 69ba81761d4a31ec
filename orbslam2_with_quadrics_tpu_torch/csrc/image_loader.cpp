// Asynchronous image loader of the PyTorch port's drivers.
//
// A copy of the reference package's native loader (native/loader.cpp). The
// original system decodes each frame synchronously on the tracking thread
// (cv::imread in its example drivers); here a pool of C++ decoder threads
// reads ahead through the sequence and delivers frames IN ORDER through a
// bounded ring, so that decoding overlaps the card's work: the host pops a
// ready frame (grayscale float32, plus the raw counts of a 16-bit image)
// without holding Python's interpreter lock.
//
// Formats: PNG (8/16-bit gray or RGB via libpng), JPEG (libjpeg), PGM/PPM.
// C API (ctypes), no C++ types across the boundary. Built at first use by
// utils/image_io.py:
//   g++ -O3 -std=c++17 -fPIC -shared image_loader.cpp -lpng -ljpeg -lpthread

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

struct Frame {
  std::vector<float> gray;      // H*W grayscale in [0,255]
  std::vector<uint16_t> raw16;  // 16-bit single channel (depth), if any
  int h = 0, w = 0;
  bool is16 = false;
  bool ok = false;
};

bool decode_png(const char* path, Frame* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  int w = png_get_image_width(png, info);
  int h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  bool keep16 = (depth == 16 && (color == PNG_COLOR_TYPE_GRAY));
  if (depth == 16 && !keep16) png_set_strip_16(png);
  if (keep16) png_set_swap(png);  // PNG is big-endian; host is LE
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<png_byte> data(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);

  out->h = h;
  out->w = w;
  if (keep16) {
    out->is16 = true;
    out->raw16.resize((size_t)h * w);
    memcpy(out->raw16.data(), data.data(), (size_t)h * w * 2);
    // also provide a float view (raw counts)
    out->gray.resize((size_t)h * w);
    for (size_t i = 0; i < out->raw16.size(); ++i)
      out->gray[i] = (float)out->raw16[i];
  } else {
    out->gray.resize((size_t)h * w);
    for (int y = 0; y < h; ++y) {
      const png_byte* r = rows[y];
      for (int x = 0; x < w; ++x) {
        if (channels >= 3) {
          // BT.601 luma, matching cv::cvtColor(BGR2GRAY) coefficients
          // used by the reference (src/Tracking.cc:173-186)
          float b = r[x * channels + 2], g = r[x * channels + 1],
                rr = r[x * channels + 0];
          out->gray[(size_t)y * w + x] = 0.299f * rr + 0.587f * g + 0.114f * b;
        } else {
          out->gray[(size_t)y * w + x] = r[x];
        }
      }
    }
  }
  out->ok = true;
  return true;
}

bool decode_jpeg(const char* path, Frame* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  out->h = h;
  out->w = w;
  out->gray.resize((size_t)h * w);
  std::vector<unsigned char> row(w);
  unsigned char* rp = row.data();
  while ((int)cinfo.output_scanline < h) {
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rp, 1);
    for (int x = 0; x < w; ++x) out->gray[(size_t)y * w + x] = row[x];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  out->ok = true;
  return true;
}

bool decode_pnm(const char* path, Frame* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  char magic[3] = {0};
  int w, h, maxv;
  if (fscanf(fp, "%2s %d %d %d", magic, &w, &h, &maxv) != 4) {
    fclose(fp);
    return false;
  }
  fgetc(fp);  // single whitespace after header
  bool ppm = magic[1] == '6';
  int ch = ppm ? 3 : 1;
  std::vector<unsigned char> data((size_t)w * h * ch);
  if (fread(data.data(), 1, data.size(), fp) != data.size()) {
    fclose(fp);
    return false;
  }
  fclose(fp);
  out->h = h;
  out->w = w;
  out->gray.resize((size_t)h * w);
  for (size_t i = 0; i < (size_t)h * w; ++i) {
    if (ppm) {
      out->gray[i] = 0.299f * data[i * 3] + 0.587f * data[i * 3 + 1] +
                     0.114f * data[i * 3 + 2];
    } else {
      out->gray[i] = data[i];
    }
  }
  out->ok = true;
  return true;
}

bool decode_any(const std::string& path, Frame* out) {
  size_t dot = path.find_last_of('.');
  std::string ext = dot == std::string::npos ? "" : path.substr(dot + 1);
  for (auto& c : ext) c = (char)tolower(c);
  if (ext == "png") return decode_png(path.c_str(), out);
  if (ext == "jpg" || ext == "jpeg") return decode_jpeg(path.c_str(), out);
  if (ext == "pgm" || ext == "ppm" || ext == "pnm")
    return decode_pnm(path.c_str(), out);
  // try PNG then JPEG as fallback
  if (decode_png(path.c_str(), out)) return true;
  return decode_jpeg(path.c_str(), out);
}

struct Loader {
  std::vector<std::string> paths;
  std::vector<Frame> ring;
  std::vector<std::atomic<int>> state;  // 0=empty 1=in-flight 2=ready
  size_t capacity;
  std::atomic<size_t> next_to_claim{0};
  size_t next_to_serve = 0;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_space;
  std::atomic<bool> stop{false};

  Loader(std::vector<std::string> p, int n_threads, int cap)
      : paths(std::move(p)), ring(cap), state(cap), capacity(cap) {
    for (auto& s : state) s.store(0);
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { work(); });
  }

  void work() {
    while (!stop.load()) {
      size_t idx = next_to_claim.fetch_add(1);
      if (idx >= paths.size()) return;
      size_t slot = idx % capacity;
      {
        // wait until the consumer has drained this slot's previous lap
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() || (idx < next_to_serve + capacity &&
                                 state[slot].load() == 0);
        });
        if (stop.load()) return;
        state[slot].store(1);
      }
      Frame f;
      decode_any(paths[idx], &f);
      {
        std::lock_guard<std::mutex> lk(mu);
        ring[slot] = std::move(f);
        state[slot].store(2);
      }
      cv_ready.notify_all();
    }
  }

  // Blocks until frame `next_to_serve` is decoded; returns pointer kept
  // valid until the following next() call.
  Frame* next() {
    if (next_to_serve >= paths.size()) return nullptr;
    size_t slot = next_to_serve % capacity;
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [&] { return stop.load() || state[slot].load() == 2; });
    if (stop.load()) return nullptr;
    return &ring[slot];
  }

  void release_current() {
    size_t slot = next_to_serve % capacity;
    {
      std::lock_guard<std::mutex> lk(mu);
      state[slot].store(0);
      next_to_serve++;
    }
    cv_space.notify_all();
  }

  ~Loader() {
    stop.store(true);
    cv_ready.notify_all();
    cv_space.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* slam_loader_create(const char** paths, int n, int n_threads, int capacity) {
  std::vector<std::string> p(paths, paths + n);
  if (capacity < 2) capacity = 2;
  if (n_threads < 1) n_threads = 1;
  return new Loader(std::move(p), n_threads, capacity);
}

// Peek dimensions of the next frame (blocks until decoded).
// Returns 0 on end-of-sequence or decode failure (h/w set to 0).
int slam_loader_peek(void* handle, int* h, int* w, int* is16) {
  auto* L = static_cast<Loader*>(handle);
  Frame* f = L->next();
  if (!f || !f->ok) {
    *h = *w = *is16 = 0;
    return 0;
  }
  *h = f->h;
  *w = f->w;
  *is16 = f->is16 ? 1 : 0;
  return 1;
}

// Copy the next frame into out (float32, h*w) and advance.
int slam_loader_next(void* handle, float* out, uint16_t* out16) {
  auto* L = static_cast<Loader*>(handle);
  Frame* f = L->next();
  if (!f || !f->ok) return 0;
  memcpy(out, f->gray.data(), f->gray.size() * sizeof(float));
  if (out16 && f->is16)
    memcpy(out16, f->raw16.data(), f->raw16.size() * sizeof(uint16_t));
  L->release_current();
  return 1;
}

void slam_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
