// Native runtime of paddle_tpu_torch: the C++ pieces of the host feed path.
//
// Reference parity: native/paddle_tpu_native.cc (the reference's threaded
// data path, paddle/framework/threadpool.h and the v2 reader's xmap thread
// pools; paddle/memory's staging buffers; its recordio dataset cache).  The
// port keeps its own copy, built by paddle_tpu_torch/runtime/native.py:
//
//   * ptq_*   - bounded MPMC ring queue of byte blobs (prefetch pipeline);
//               blocking push/pop release the GIL through ctypes, so
//               producers decode in parallel with the train step.
//   * rio_*   - record reader/writer, the wire format of io_recordio.py
//               ("PTRC" magic, per record: u32 len, u32 crc32, payload).
//   * arena_* - fixed-block host arena for assembled batches.  Pinned
//               (page-locked) host blocks come from torch's pinned
//               allocator instead (runtime/feed.py): their pages must be
//               registered with the CUDA driver.
//
// Build: g++ -O2 -shared -fPIC -pthread -o libpaddle_tpu_torch_native.so
//        paddle_tpu_native.cc   (runtime/native.py does this at first use).
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

// ---------------------------------------------------------------- crc32
uint32_t crc_table[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc_table[i] = c;
    }
  }
} crc_init;

uint32_t crc32(const unsigned char* buf, size_t len) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------------- ring queue
struct Blob {
  char* data;
  long len;
};

struct Queue {
  std::deque<Blob> items;
  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;
  size_t capacity;
  bool closed = false;
};

// ---------------------------------------------------------------- arena
struct Arena {
  std::vector<char*> blocks;     // all blocks (for destroy)
  std::deque<char*> free_list;
  std::mutex mu;
  std::condition_variable not_empty;
  long block_size;
};

}  // namespace

extern "C" {

// ---- queue ----
void* ptq_create(int capacity) {
  Queue* q = new Queue();
  q->capacity = capacity > 0 ? (size_t)capacity : 1;
  return q;
}

// Blocks while full.  Returns 0 on success, -1 if the queue was closed.
int ptq_push(void* vq, const char* data, long len) {
  Queue* q = (Queue*)vq;
  std::unique_lock<std::mutex> lk(q->mu);
  q->not_full.wait(lk, [q] {
    return q->closed || q->items.size() < q->capacity;
  });
  if (q->closed) return -1;
  char* copy = (char*)malloc(len > 0 ? len : 1);
  memcpy(copy, data, len);
  q->items.push_back({copy, len});
  q->not_empty.notify_one();
  return 0;
}

// Blocks while empty.  Returns the blob length and stores a malloc'd
// pointer in *out (caller frees with ptq_free); -1 when closed and
// drained.
long ptq_pop(void* vq, char** out) {
  Queue* q = (Queue*)vq;
  std::unique_lock<std::mutex> lk(q->mu);
  q->not_empty.wait(lk, [q] { return q->closed || !q->items.empty(); });
  if (q->items.empty()) return -1;  // closed + drained
  Blob b = q->items.front();
  q->items.pop_front();
  q->not_full.notify_one();
  *out = b.data;
  return b.len;
}

void ptq_free(char* buf) { free(buf); }

// After close: pushes fail, pops drain the remaining items then return -1.
void ptq_close(void* vq) {
  Queue* q = (Queue*)vq;
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->not_full.notify_all();
  q->not_empty.notify_all();
}

int ptq_size(void* vq) {
  Queue* q = (Queue*)vq;
  std::lock_guard<std::mutex> lk(q->mu);
  return (int)q->items.size();
}

void ptq_destroy(void* vq) {
  Queue* q = (Queue*)vq;
  {
    std::lock_guard<std::mutex> lk(q->mu);
    for (auto& b : q->items) free(b.data);
    q->items.clear();
    q->closed = true;
  }
  q->not_full.notify_all();
  q->not_empty.notify_all();
  delete q;
}

// ---- recordio ----
static const char kMagic[4] = {'P', 'T', 'R', 'C'};

void* rio_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  if (fwrite(kMagic, 1, 4, f) != 4) {
    fclose(f);
    return nullptr;
  }
  return f;
}

int rio_writer_write(void* vf, const char* data, long len) {
  FILE* f = (FILE*)vf;
  uint32_t hdr[2] = {(uint32_t)len,
                     crc32((const unsigned char*)data, (size_t)len)};
  if (fwrite(hdr, 4, 2, f) != 2) return -1;
  if (len > 0 && fwrite(data, 1, (size_t)len, f) != (size_t)len) return -1;
  return 0;
}

int rio_writer_close(void* vf) {
  return fclose((FILE*)vf) == 0 ? 0 : -1;
}

void* rio_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char magic[4];
  if (fread(magic, 1, 4, f) != 4 || memcmp(magic, kMagic, 4) != 0) {
    fclose(f);
    return nullptr;
  }
  return f;
}

// Returns payload length with a malloc'd buffer in *out (free with
// ptq_free); -1 at EOF, -2 on CRC mismatch, -3 on truncation.
long rio_reader_next(void* vf, char** out) {
  FILE* f = (FILE*)vf;
  uint32_t hdr[2];
  size_t n = fread(hdr, 4, 2, f);
  if (n == 0) return -1;  // clean EOF
  if (n != 2) return -3;
  uint32_t len = hdr[0], crc = hdr[1];
  char* buf = (char*)malloc(len > 0 ? len : 1);
  if (len > 0 && fread(buf, 1, len, f) != len) {
    free(buf);
    return -3;
  }
  if (crc32((const unsigned char*)buf, len) != crc) {
    free(buf);
    return -2;
  }
  *out = buf;
  return (long)len;
}

void rio_reader_close(void* vf) { fclose((FILE*)vf); }

// ---- staging arena ----
void* arena_create(long block_size, int blocks) {
  Arena* a = new Arena();
  a->block_size = block_size;
  for (int i = 0; i < blocks; ++i) {
    // 64-byte alignment: cache-line (and XLA host buffer) friendly
    char* p = nullptr;
    if (posix_memalign((void**)&p, 64, (size_t)block_size) != 0) {
      for (char* q : a->blocks) free(q);
      delete a;
      return nullptr;
    }
    a->blocks.push_back(p);
    a->free_list.push_back(p);
  }
  return a;
}

// Blocks until a block is free.
char* arena_acquire(void* va) {
  Arena* a = (Arena*)va;
  std::unique_lock<std::mutex> lk(a->mu);
  a->not_empty.wait(lk, [a] { return !a->free_list.empty(); });
  char* p = a->free_list.front();
  a->free_list.pop_front();
  return p;
}

void arena_release(void* va, char* p) {
  Arena* a = (Arena*)va;
  std::lock_guard<std::mutex> lk(a->mu);
  a->free_list.push_back(p);
  a->not_empty.notify_one();
}

long arena_block_size(void* va) { return ((Arena*)va)->block_size; }

int arena_free_blocks(void* va) {
  Arena* a = (Arena*)va;
  std::lock_guard<std::mutex> lk(a->mu);
  return (int)a->free_list.size();
}

void arena_destroy(void* va) {
  Arena* a = (Arena*)va;
  for (char* p : a->blocks) free(p);
  delete a;
}

}  // extern "C"
