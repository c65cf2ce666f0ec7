// Native KITTI sequence loader with background prefetch.
//
// Native replacement for the runtime role of `kittiHelper`
// (/root/reference/Node/kittiHelper.cpp:25-182): the reference feeds frames
// through ROS topics from a foreground loop; here a C++ thread pool decodes
// PNG images (libpng) and velodyne .bin scans ahead of the SLAM loop so host
// IO fully overlaps device compute. Exposed as a plain C ABI for ctypes
// (no pybind11 in this toolchain).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 kitti_loader.cpp -lpng -lz -pthread
//        -o libkittiloader.so

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct FrameData {
  std::vector<float> img;  // grayscale, row-major
  int height = 0, width = 0;
  std::vector<float> velo;  // x,y,z,intensity records
  int n_points = 0;
  bool img_ok = false, velo_ok = false;
};

bool read_png_gray(const std::string& path, std::vector<float>& out, int& H,
                   int& W) {
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  W = png_get_image_width(png, info);
  H = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  // Collapse everything to 8-bit gray.
  if (color & PNG_COLOR_MASK_COLOR)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  out.resize(static_cast<size_t>(H) * W);
  for (int y = 0; y < H; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out.data() + static_cast<size_t>(y) * W;
    for (int x = 0; x < W; ++x) dst[x] = static_cast<float>(row[x]);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return true;
}

bool read_velo_bin(const std::string& path, std::vector<float>& out, int& n) {
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp) return false;
  fseek(fp, 0, SEEK_END);
  long bytes = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  n = static_cast<int>(bytes / (4 * sizeof(float)));
  out.resize(static_cast<size_t>(n) * 4);
  size_t got = fread(out.data(), sizeof(float), out.size(), fp);
  fclose(fp);
  return got == out.size();
}

class Loader {
 public:
  Loader(std::string img_dir, std::string velo_dir, int num_frames,
         int n_threads, int window)
      : img_dir_(std::move(img_dir)),
        velo_dir_(std::move(velo_dir)),
        num_frames_(num_frames),
        window_(window) {
    for (int i = 0; i < n_threads; ++i)
      workers_.emplace_back([this] { worker(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Schedule decode of [idx, idx + window) and drop cache entries < idx.
  void prefetch(int idx) {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto it = cache_.begin(); it != cache_.end();)
      it = (it->first < idx) ? cache_.erase(it) : std::next(it);
    for (int i = idx; i < std::min(idx + window_, num_frames_); ++i)
      if (!cache_.count(i) && !pending_.count(i)) {
        queue_.push_back(i);
        pending_.insert({i, true});
      }
    cv_.notify_all();
  }

  std::shared_ptr<FrameData> get(int idx) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = cache_.find(idx);
    if (it != cache_.end() && it->second->img_ok && it->second->velo_ok)
      return it->second;
    if (!pending_.count(idx)) {
      queue_.push_front(idx);
      pending_.insert({idx, true});
      cv_.notify_one();
    }
    done_cv_.wait(lk, [&] {
      auto i2 = cache_.find(idx);
      return i2 != cache_.end() && i2->second->img_ok && i2->second->velo_ok;
    });
    return cache_[idx];
  }

 private:
  void worker() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
        if (stop_) return;
        idx = queue_.front();
        queue_.pop_front();
      }
      auto fd = std::make_shared<FrameData>();
      char name[32];
      snprintf(name, sizeof(name), "/%06d.png", idx);
      fd->img_ok = img_dir_.empty() ||
                   read_png_gray(img_dir_ + name, fd->img, fd->height, fd->width);
      snprintf(name, sizeof(name), "/%06d.bin", idx);
      fd->velo_ok = velo_dir_.empty() ||
                    read_velo_bin(velo_dir_ + name, fd->velo, fd->n_points);
      if (!fd->img_ok) fd->img_ok = true;   // missing file -> empty frame
      if (!fd->velo_ok) fd->velo_ok = true;
      {
        std::lock_guard<std::mutex> lk(mu_);
        cache_[idx] = fd;
        pending_.erase(idx);
      }
      done_cv_.notify_all();
    }
  }

  std::string img_dir_, velo_dir_;
  int num_frames_, window_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::deque<int> queue_;
  std::unordered_map<int, bool> pending_;
  std::unordered_map<int, std::shared_ptr<FrameData>> cache_;
  std::vector<std::thread> workers_;
  std::atomic<bool> stop_{false};
};

}  // namespace

extern "C" {

void* kl_open(const char* img_dir, const char* velo_dir, int num_frames,
              int n_threads, int window) {
  return new Loader(img_dir ? img_dir : "", velo_dir ? velo_dir : "",
                    num_frames, n_threads, window);
}

void kl_close(void* h) { delete static_cast<Loader*>(h); }

void kl_prefetch(void* h, int idx) { static_cast<Loader*>(h)->prefetch(idx); }

// Returns 0 on success; fills dims. Frame stays cached until prefetch moves on.
int kl_frame_info(void* h, int idx, int* height, int* width, int* n_points) {
  auto fd = static_cast<Loader*>(h)->get(idx);
  *height = fd->height;
  *width = fd->width;
  *n_points = fd->n_points;
  return 0;
}

int kl_copy_image(void* h, int idx, float* out) {
  auto fd = static_cast<Loader*>(h)->get(idx);
  std::memcpy(out, fd->img.data(), fd->img.size() * sizeof(float));
  return 0;
}

int kl_copy_velodyne(void* h, int idx, float* out) {
  auto fd = static_cast<Loader*>(h)->get(idx);
  std::memcpy(out, fd->velo.data(), fd->velo.size() * sizeof(float));
  return 0;
}

}  // extern "C"
