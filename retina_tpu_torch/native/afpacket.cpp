// Live AF_PACKET capture over a TPACKET_V3 mmap'd ring.
//
// Reference analog: the packetparser's kernel->user perf ring
// (pkg/plugin/packetparser/types_linux.go:67-69 — 32 pages/CPU
// "determined via testing on a large cluster"; the kernel writes packet
// records, userspace drains blocks). A Python recv() per packet caps
// live capture around 50-100k pps on one core; TPACKET_V3 hands
// userspace whole BLOCKS of frames via shared memory with one poll()
// per block, and the frame decode runs in C (rt_decode_eth_frame,
// decoder.cpp) straight into the 16-lane record layout the device
// wants. Kernel-side drops stay visible through PACKET_STATISTICS —
// the same drop-and-count contract as everywhere else.
//
// Exposed via ctypes (native/__init__.py AfPacketRing); the plugin
// falls back to the per-packet Python socket loop when unavailable.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#if defined(__linux__)

#include <arpa/inet.h>
#include <cerrno>
#include <linux/if_ether.h>
#include <linux/if_packet.h>
#include <net/if.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

extern "C" bool rt_decode_eth_frame(const uint8_t* pkt, size_t caplen,
                                    uint64_t ts_ns, uint32_t obs_point,
                                    uint32_t direction, uint32_t* r);

namespace {

constexpr int NUM_FIELDS = 16;

struct AfpHandle {
  int fd = -1;
  uint8_t* map = nullptr;
  size_t map_len = 0;
  uint32_t block_size = 0;
  uint32_t block_nr = 0;
  uint32_t cur_block = 0;
  uint32_t resume_idx = 0;  // packets already consumed from cur_block
  uint64_t kernel_drops = 0;  // cumulative from PACKET_STATISTICS
};

}  // namespace

extern "C" {

// Open a TPACKET_V3 rx ring on `iface` ("" = all interfaces).
// Returns an opaque handle or nullptr (errno describes the failure —
// typically EPERM without CAP_NET_RAW).
void* rt_afp_open(const char* iface, uint32_t block_size,
                  uint32_t block_nr) {
  if (block_size == 0) block_size = 1u << 20;  // 1 MiB blocks
  if (block_nr == 0) block_nr = 32;            // 32 MiB ring
  // Protocol 0: the socket receives NOTHING until bind() attaches it to
  // the interface with ETH_P_ALL — otherwise frames from every
  // interface land in the ring during setup and get misattributed.
  int fd = socket(AF_PACKET, SOCK_RAW, 0);
  if (fd < 0) return nullptr;

  int ver = TPACKET_V3;
  if (setsockopt(fd, SOL_PACKET, PACKET_VERSION, &ver, sizeof(ver)) != 0) {
    close(fd);
    return nullptr;
  }
  struct tpacket_req3 req;
  std::memset(&req, 0, sizeof(req));
  req.tp_block_size = block_size;
  req.tp_block_nr = block_nr;
  req.tp_frame_size = 2048;  // v3 packs variably; sizing hint only
  req.tp_frame_nr = (block_size / req.tp_frame_size) * block_nr;
  req.tp_retire_blk_tov = 10;  // ms: hand over partial blocks promptly
  req.tp_feature_req_word = 0;
  if (setsockopt(fd, SOL_PACKET, PACKET_RX_RING, &req, sizeof(req)) != 0) {
    close(fd);
    return nullptr;
  }
  size_t map_len = static_cast<size_t>(block_size) * block_nr;
  void* map = mmap(nullptr, map_len, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_LOCKED, fd, 0);
  if (map == MAP_FAILED) {
    // MAP_LOCKED can exceed RLIMIT_MEMLOCK; retry unlocked.
    map = mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  }
  if (map == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  struct sockaddr_ll ll;
  std::memset(&ll, 0, sizeof(ll));
  ll.sll_family = AF_PACKET;
  ll.sll_protocol = htons(ETH_P_ALL);
  ll.sll_ifindex = (iface && iface[0]) ? static_cast<int>(
                       if_nametoindex(iface)) : 0;
  if (iface && iface[0] && ll.sll_ifindex == 0) {
    munmap(map, map_len);
    close(fd);
    return nullptr;
  }
  if (bind(fd, reinterpret_cast<struct sockaddr*>(&ll), sizeof(ll)) != 0) {
    munmap(map, map_len);
    close(fd);
    return nullptr;
  }
  AfpHandle* h = new AfpHandle();
  h->fd = fd;
  h->map = static_cast<uint8_t*>(map);
  h->map_len = map_len;
  h->block_size = block_size;
  h->block_nr = block_nr;
  return h;
}

// Drain ready blocks into out[max_records][16]. Waits up to timeout_ms
// for the first ready block. Returns records decoded (>= 0) or -1 on a
// poll error. n_seen counts every frame the kernel handed over
// (decoded or not); frames beyond max_records stay in the ring for the
// next call (the block is only released once fully consumed).
// DNS sidecar: raw frames of decoded DNS packets are appended to
// dns_buf as [u16 caplen][frame bytes] up to dns_cap (host Python
// extracts qname STRINGS from them — strings never cross into the
// record lanes). dns_buf may be null.
long rt_afp_poll(void* handle, uint32_t timeout_ms, uint32_t obs_point,
                 uint32_t* out, size_t max_records, uint64_t* n_seen,
                 uint8_t* dns_buf, size_t dns_cap, size_t* dns_used) {
  AfpHandle* h = static_cast<AfpHandle*>(handle);
  const uint32_t direction = (obs_point == 1 || obs_point == 2) ? 1u : 2u;
  size_t n = 0;
  if (n_seen) *n_seen = 0;
  if (dns_used) *dns_used = 0;
  bool waited = false;
  while (n < max_records) {
    uint8_t* block = h->map + static_cast<size_t>(h->cur_block) *
                                  h->block_size;
    auto* bd = reinterpret_cast<struct tpacket_block_desc*>(block);
    if (!(bd->hdr.bh1.block_status & TP_STATUS_USER)) {
      if (waited || n > 0) break;  // drained everything ready
      struct pollfd pfd = {h->fd, POLLIN | POLLERR, 0};
      int rc = poll(&pfd, 1, static_cast<int>(timeout_ms));
      if (rc < 0) {
        if (errno == EINTR) continue;  // signals are not errors
        return -1;
      }
      waited = true;
      if (rc == 0) break;
      continue;
    }
    uint32_t num_pkts = bd->hdr.bh1.num_pkts;
    auto* ppd = reinterpret_cast<struct tpacket3_hdr*>(
        block + bd->hdr.bh1.offset_to_first_pkt);
    bool partial = false;
    for (uint32_t i = 0; i < num_pkts; i++) {
      if (i >= h->resume_idx) {
        if (n >= max_records) {
          // Out buffer full mid-block: remember how far we got; the
          // next call resumes at this packet without re-emitting
          // earlier frames.
          h->resume_idx = i;
          partial = true;
          break;
        }
        if (n_seen) (*n_seen)++;
        const uint8_t* frame = reinterpret_cast<const uint8_t*>(ppd) +
                               ppd->tp_mac;
        uint64_t ts_ns = static_cast<uint64_t>(ppd->tp_sec) *
                             1000000000ull +
                         ppd->tp_nsec;
        uint32_t* r = out + n * NUM_FIELDS;
        if (rt_decode_eth_frame(frame, ppd->tp_snaplen, ts_ns, obs_point,
                                direction, r)) {
          // EVENT_TYPE lanes 2/3 = DNS req/resp (events/schema.py):
          // stash the raw frame for the host-side qname string pass.
          if (dns_buf && dns_used && (r[14] == 2u || r[14] == 3u) &&
              *dns_used + 2 + ppd->tp_snaplen <= dns_cap) {
            uint16_t cl = static_cast<uint16_t>(
                ppd->tp_snaplen > 0xFFFF ? 0xFFFF : ppd->tp_snaplen);
            std::memcpy(dns_buf + *dns_used, &cl, 2);
            std::memcpy(dns_buf + *dns_used + 2, frame, cl);
            *dns_used += 2 + cl;
          }
          n++;
        }
      }
      ppd = reinterpret_cast<struct tpacket3_hdr*>(
          reinterpret_cast<uint8_t*>(ppd) + ppd->tp_next_offset);
    }
    if (partial) break;
    h->resume_idx = 0;
    bd->hdr.bh1.block_status = TP_STATUS_KERNEL;
    __sync_synchronize();
    h->cur_block = (h->cur_block + 1) % h->block_nr;
  }
  return static_cast<long>(n);
}

// Cumulative kernel drop count (PACKET_STATISTICS is read-and-reset;
// the handle accumulates so callers see a monotonic counter).
uint64_t rt_afp_drops(void* handle) {
  AfpHandle* h = static_cast<AfpHandle*>(handle);
  struct tpacket_stats_v3 st;
  socklen_t len = sizeof(st);
  if (getsockopt(h->fd, SOL_PACKET, PACKET_STATISTICS, &st, &len) == 0) {
    h->kernel_drops += st.tp_drops;
  }
  return h->kernel_drops;
}

void rt_afp_close(void* handle) {
  AfpHandle* h = static_cast<AfpHandle*>(handle);
  if (h->map) munmap(h->map, h->map_len);
  if (h->fd >= 0) close(h->fd);
  delete h;
}

}  // extern "C"

#else  // !__linux__

extern "C" {
void* rt_afp_open(const char*, uint32_t, uint32_t) { return nullptr; }
long rt_afp_poll(void*, uint32_t, uint32_t, uint32_t*, size_t, uint64_t*,
                 uint8_t*, size_t, size_t*) {
  return -1;
}
uint64_t rt_afp_drops(void*) { return 0; }
void rt_afp_close(void*) {}
}

#endif
