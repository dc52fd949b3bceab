// Native image codec + prefetching decode pool.
//
// The TPU-native counterpart of the reference's prebuilt OpenCV JNI layer
// (org.opencv % opencv_jni, loaded per-partition via NativeLoader —
// core/env/src/main/scala/NativeLoader.java). Exposed through ctypes
// (mmlspark_tpu/utils/native_loader.py) instead of JNI.
//
// Output convention: row-major uint8 BGR, matching the reference ImageSchema
// (core/schema/src/main/scala/ImageSchema.scala:18-23).
//
// Build: g++ -O2 -fPIC -shared imagecodec.cc -o libmmlimage.so -ljpeg -lpng -lpthread

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>
#include <queue>
#include <mutex>
#include <condition_variable>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------- JPEG
struct mml_jpeg_err {
  struct jpeg_error_mgr pub;
  jmp_buf jb;
};

static void mml_jpeg_error_exit(j_common_ptr cinfo) {
  mml_jpeg_err* err = reinterpret_cast<mml_jpeg_err*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode JPEG bytes to malloc'd BGR buffer. Returns 0 on success.
int mml_decode_jpeg(const unsigned char* data, long size,
                    unsigned char** out, int* width, int* height) {
  struct jpeg_decompress_struct cinfo;
  struct mml_jpeg_err jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = mml_jpeg_error_exit;
  // volatile: assigned between setjmp and a potential longjmp
  unsigned char* volatile buf = nullptr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = JCS_EXT_BGR;  // decode straight to BGR
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  const int stride = w * 3;
  buf = static_cast<unsigned char*>(malloc(static_cast<size_t>(stride) * h));
  if (!buf) { jpeg_destroy_decompress(&cinfo); return 1; }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = buf + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buf;
  *width = w;
  *height = h;
  return 0;
}

// Encode BGR buffer to JPEG (quality q). Returns 0 on success.
int mml_encode_jpeg(const unsigned char* bgr, int width, int height, int q,
                    unsigned char** out, unsigned long* out_size) {
  struct jpeg_compress_struct cinfo;
  struct mml_jpeg_err jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = mml_jpeg_error_exit;
  unsigned char* volatile mem = nullptr;
  unsigned long mem_size = 0;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    free(mem);
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, const_cast<unsigned char**>(&mem), &mem_size);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_EXT_BGR;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, q, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const int stride = width * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    const unsigned char* row = bgr + static_cast<size_t>(cinfo.next_scanline) * stride;
    jpeg_write_scanlines(&cinfo, const_cast<unsigned char**>(&row), 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = mem;
  *out_size = mem_size;
  return 0;
}

// ---------------------------------------------------------------- PNG
struct mml_png_reader {
  const unsigned char* data;
  size_t size;
  size_t pos;
};

static void mml_png_read(png_structp png, png_bytep out, png_size_t n) {
  mml_png_reader* r = static_cast<mml_png_reader*>(png_get_io_ptr(png));
  if (r->pos + n > r->size) { png_error(png, "eof"); }
  memcpy(out, r->data + r->pos, n);
  r->pos += n;
}

int mml_decode_png(const unsigned char* data, long size,
                   unsigned char** out, int* width, int* height) {
  if (png_sig_cmp(data, 0, 8)) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                           nullptr, nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  // volatile: assigned between setjmp and a possible longjmp
  unsigned char* volatile buf = nullptr;
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(buf);
    return 1;
  }
  mml_png_reader reader{data, static_cast<size_t>(size), 0};
  png_set_read_fn(png, &reader, mml_png_read);
  png_read_info(png, info);
  png_set_expand(png);          // palette/gray/low-depth -> 8-bit
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_set_bgr(png);             // emit BGR directly
  png_read_update_info(png, info);
  const int w = png_get_image_width(png, info);
  const int h = png_get_image_height(png, info);
  const int stride = w * 3;
  buf = static_cast<unsigned char*>(malloc(static_cast<size_t>(stride) * h));
  if (!buf) { png_destroy_read_struct(&png, &info, nullptr); return 1; }
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = buf + static_cast<size_t>(y) * stride;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  *out = buf;
  *width = w;
  *height = h;
  return 0;
}

void mml_free(void* p) { free(p); }

// ---------------------------------------------------------------- batch pool
// Threaded batch decode: the host-side producer feeding device prefetch.
// One call decodes N images in parallel; rows that fail decode get width=0.
struct DecodeJob {
  const unsigned char* data;
  long size;
  unsigned char* out;
  int w, h, ok;
};

int mml_decode_batch(const unsigned char** datas, const long* sizes, int n,
                     unsigned char** outs, int* widths, int* heights,
                     int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::mutex m;
  int next = 0;
  auto worker = [&]() {
    for (;;) {
      int i;
      { std::lock_guard<std::mutex> g(m); if (next >= n) return; i = next++; }
      unsigned char* out = nullptr;
      int w = 0, h = 0;
      int rc = 1;
      if (sizes[i] >= 8) {
        const unsigned char* d = datas[i];
        if (d[0] == 0xFF && d[1] == 0xD8) {
          rc = mml_decode_jpeg(d, sizes[i], &out, &w, &h);
        } else if (!png_sig_cmp(d, 0, 8)) {
          rc = mml_decode_png(d, sizes[i], &out, &w, &h);
        }
      }
      outs[i] = rc == 0 ? out : nullptr;
      widths[i] = rc == 0 ? w : 0;
      heights[i] = rc == 0 ? h : 0;
    }
  };
  const int k = n_threads < n ? n_threads : n;
  pool.reserve(k);
  for (int t = 0; t < k; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return 0;
}

}  // extern "C"
