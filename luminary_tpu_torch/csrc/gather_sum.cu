// gather_sum (kernel E): K row fetches summed per column, and a chain of
// dependent row fetches.
//
// Replaces the two scalar-loop Pallas prototypes:
//   tools/proto_pallas_gather.py  e2_scalar_loop (:96, pallas_call :112):
//     out[c] = sum over i < K of tab[idx[i], c], added i = 0, 1, ..., K - 1;
//   tools/proto_pallas_gather2.py e2c_scalar_loop (:40, pallas_call :64):
//     a chain of `steps` fetches in which each row chooses the next index:
//       idx_0     = floormod(int32(f32(seed) * 1e6), S)
//       acc      += tab[idx_j]
//       idx_{j+1} = floormod(floormod(int32(f32(idx_j) + row[0] * 0 + 1), S)
//                            + (row[1] > 2), S)
//     with int32() truncating toward zero and floormod taking the sign of S,
//     as jnp's `%` does, so a negative seed works.
// A scalar index outside [0, S) wraps once (k + S) and then clamps into
// [0, S - 1], as the prototype's tab_ref[idx, :] does in Pallas's interpret
// mode.
//
// Bound on an NVIDIA H100 80GB HBM3 at 700.00 W (3.35 TB/s, 67 TFLOP/s
// fp32). By bytes, the prototype's K = 2048 rows of 512 B are 1 MB (0.31 us)
// and the chain's 4096 rows 2 MB (0.63 us). But each column is summed in
// index order, so that it equals the sequential plain version bit for bit,
// and that order is a chain of K dependent float adds: ~4 cycles each, so
// ~4 us for K = 2048 and ~8 us for 4096 steps at a ~2 GHz SM clock. That
// chain is the floor; everything else is hidden behind it or kept short.
//
// Design. One block per float4 column group (32 blocks for 128 columns), so
// the columns' independent sums run on separate SMs. The rows reach shared
// memory through a two-stage ring of STAGE rows: the copying threads issue
// cp.async copies of stage s + 1 while the lane 0 of warps 0-3 add stage s,
// one float component each (four dependent add chains on four schedulers),
// in index order, each reading its next ADD values ahead of its adds. In a
// block of more than 4 warps only the other warps copy, so that no adder
// waits on an index load.
// - gather_sum reads its indices from idx (the clamp rule) as it issues.
// - gather_chain first lists the visited rows. next(r) depends on row r
//   alone (its columns 0 and 1), so every block computes nxt[r] for all S
//   rows at once into shared memory, then next^JUMP by pointer doubling
//   (log2 JUMP parallel rounds). One thread follows next^JUMP from the
//   chain's start to the start of each chunk of JUMP steps, then one thread
//   per chunk follows nxt through it: SEQ / JUMP + JUMP dependent shared
//   loads list SEQ steps, which the ring then sums in order. Any S and steps
//   work, cycles included. Shared indices are padded (pad()), since chunks
//   and chains that lie 32 or 64 rows apart would share a bank. Where three
//   tables of S ints do not fit beside the ring (S above ~16,000 rows on an
//   H100), thread 0 lists the rows by walking the table itself, one L2 or
//   memory round trip a step, as the one-warp design did.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The sizes below are fixed for the card; the guards only let the CPU
// emulation tests build this source at small sizes
// (tests/test_torch_proto_gather.py E_EMU_DEFINES).
#ifndef SUM_THREADS
#define SUM_THREADS 256     // threads of a gather_sum block
#endif
#ifndef CHAIN_THREADS
#define CHAIN_THREADS 1024  // threads of a gather_chain block
#endif
#ifndef STAGE
#define STAGE 512           // rows of one stage of the ring
#endif
#ifndef SEQ
#define SEQ 4096            // chain steps listed at a time (a multiple of JUMP)
#endif
#ifndef JUMP
#define JUMP 64             // chain steps one jmp entry spans (a power of 2)
#endif
#define ADD 16              // values an adder reads ahead of its adds

// a padded shared-memory index: chains and chunk starts that lie 32 or 64
// rows apart would otherwise meet in one bank
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ long long clamp_row(long long k, long long rows) {
  if (k < 0) k += rows;
  return k < 0 ? 0 : (k >= rows ? rows - 1 : k);
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// the chain's next index after row `idx`, whose columns 0-3 are `r`
__device__ __forceinline__ int next_index(float4 r, int idx, int rows) {
  const float f = ((float)idx + r.x * 0.0f) + 1.0f;
  const int n = floor_mod((int)f, rows);
  return floor_mod(n + (r.y > 2.0f ? 1 : 0), rows);
}

// a + b[0] + b[4] + ... + b[4 (m - 1)], added in that order; the next ADD
// values are read from shared memory while the adds of these run
__device__ __forceinline__ float add_in_order(const float* b, int m, float a) {
  const int full = m / ADD * ADD;
  float v[ADD], w[ADD];
#pragma unroll
  for (int u = 0; u < ADD; ++u) v[u] = full > 0 ? b[4 * u] : 0.0f;
  for (int i = 0; i < full; i += ADD) {
    if (i + ADD < full) {
#pragma unroll
      for (int u = 0; u < ADD; ++u) w[u] = b[4 * (i + ADD + u)];
    }
#pragma unroll
    for (int u = 0; u < ADD; ++u) a += v[u];
#pragma unroll
    for (int u = 0; u < ADD; ++u) v[u] = w[u];
  }
  for (int i = full; i < m; ++i) a += b[4 * i];
  return a;
}

// acc[c] += tab[row(i)][4 col + c] for i = 0 .. n - 1, in that order. The
// thread at lane 0 of warp w holds the sums of components w, w + warps, ...
// (all four in one thread for a one-warp block); the other threads only copy.
// Ends in a barrier, so the caller may reuse the ring and what row() reads.
template <int THREADS, class Row>
__device__ __forceinline__ void ordered_sum(const float4* __restrict__ tab,
                                            int cols4, int col, long long n,
                                            Row row, float4* ring, float acc[4]) {
  const int t = threadIdx.x;
  const long long stages = (n + STAGE - 1) / STAGE;
  // warps 0-3 add and the rest copy, so that no adder waits on an index
  // load; a block of at most 4 warps copies with every thread
  constexpr int COPIERS = THREADS > 128 ? THREADS - 128 : THREADS;
  const int ct = t - (THREADS - COPIERS);
  auto issue = [&](long long s) {
    float4* dst = ring + (s & 1) * STAGE;
    const long long base = s * STAGE;
    const int m = (int)min((long long)STAGE, n - base);
    for (int i = ct; i >= 0 && i < m; i += COPIERS)
      __pipeline_memcpy_async(dst + i, tab + row(base + i) * cols4 + col,
                              sizeof(float4));
    __pipeline_commit();
  };
  if (stages > 0) issue(0);
  for (long long s = 0; s < stages; ++s) {
    __pipeline_wait_prior(0);
    __syncthreads();  // stage s has landed; stage s - 1's adds are done
    if (s + 1 < stages) issue(s + 1);
    if ((t & 31) == 0) {
      const float* b = (const float*)(ring + (s & 1) * STAGE);
      const int m = (int)min((long long)STAGE, n - s * STAGE);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c % (THREADS / 32) == t / 32) acc[c] = add_in_order(b + c, m, acc[c]);
      }
    }
  }
  __syncthreads();
}

template <int THREADS>
__device__ __forceinline__ void store_sums(const float acc[4], float* out,
                                           int col) {
  const int t = threadIdx.x;
  if ((t & 31) != 0) return;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c % (THREADS / 32) == t / 32) out[4 * col + c] = acc[c];
}

__global__ void __launch_bounds__(SUM_THREADS)
gather_sum_kernel(const float4* __restrict__ tab, long long rows, int cols4,
                  const int32_t* __restrict__ idx, long long k_n,
                  float* __restrict__ out) {
  extern __shared__ float4 smem[];  // the ring, 2 STAGE rows
  const int col = blockIdx.x;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  ordered_sum<SUM_THREADS>(
      tab, cols4, col, k_n,
      [&](long long i) { return clamp_row(idx[i], rows); }, smem, acc);
  store_sums<SUM_THREADS>(acc, out, col);
}

// kTable: nxt and jmp in shared memory; else thread 0 walks the table
template <bool kTable>
__global__ void __launch_bounds__(CHAIN_THREADS)
gather_chain_kernel(const float4* __restrict__ tab, int rows, int cols4,
                    const float* __restrict__ seed, int steps,
                    float* __restrict__ out) {
  // the ring (2 STAGE rows), the listed steps (SEQ ints), then with kTable
  // nxt, jmp and a scratch table (padded rows ints each)
  extern __shared__ float4 smem[];
  __shared__ int starts[SEQ / JUMP];
  __shared__ int carry;
  float4* ring = smem;
  int* seq = (int*)(ring + 2 * STAGE);
  int* nxt = seq + pad(SEQ);
  const int t = threadIdx.x;
  const int col = blockIdx.x;
  const int* hop = nxt;  // next^JUMP once the tables are built
  if (kTable) {
    int* tables[2] = {nxt + pad(rows), nxt + 2 * pad(rows)};
    for (int r = t; r < rows; r += CHAIN_THREADS)
      nxt[pad(r)] = next_index(tab[(long long)r * cols4], r, rows);
    __syncthreads();
    // pointer doubling: next^2, next^4, ..., next^JUMP
    for (int span = 1, b = 0; span < JUMP; span *= 2, b ^= 1) {
      for (int r = t; r < rows; r += CHAIN_THREADS)
        tables[b][pad(r)] = hop[pad(hop[pad(r)])];
      __syncthreads();
      hop = tables[b];
    }
  }
  int cur = floor_mod((int)(seed[0] * 1e6f), rows);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long done = 0; done < steps; done += SEQ) {
    const int m = (int)min((long long)SEQ, (long long)steps - done);
    if (kTable) {
      const int chunks = (m + JUMP - 1) / JUMP;
      if (t == 0) {
        int c = cur;
        for (int k = 0; k < chunks; ++k) {
          starts[k] = c;
          c = hop[pad(c)];
        }
        carry = c;  // next^(chunks JUMP): the next pass's start when m == SEQ
      }
      __syncthreads();
      for (int k = t; k < chunks; k += CHAIN_THREADS) {
        int x = starts[k];
        const int end = min(m, (k + 1) * JUMP);
        for (int p = k * JUMP; p < end; ++p) {
          seq[pad(p)] = x;
          x = nxt[pad(x)];
        }
      }
    } else if (t == 0) {
      int c = cur;
      for (int p = 0; p < m; ++p) {
        seq[pad(p)] = c;
        c = next_index(tab[(long long)c * cols4], c, rows);
      }
      carry = c;
    }
    __syncthreads();
    cur = carry;
    ordered_sum<CHAIN_THREADS>(
        tab, cols4, col, m, [&](long long i) { return (long long)seq[pad((int)i)]; },
        ring, acc);
  }
  store_sums<CHAIN_THREADS>(acc, out, col);
}

// The opt-in limit and cudaFuncSetAttribute hold per device: the state
// below is kept per device, indexed by the current one.
constexpr int MAX_DEVICES = 64;

static int current_device(int* dev) {
  const int rc = (int)cudaGetDevice(dev);
  if (rc != 0) return rc;
  return *dev >= 0 && *dev < MAX_DEVICES ? 0 : (int)cudaErrorInvalidValue;
}

static int smem_optin(int dev) {
  static int bytes[MAX_DEVICES] = {};
  if (bytes[dev] <= 0)
    cudaDeviceGetAttribute(&bytes[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes[dev];
}

// let `kernel` take `bytes` of dynamic shared memory on the current device
// (set once per size, so that no call is made while a CUDA graph captures
// the launch)
template <class K>
static int allow_smem(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == 0) *allowed = bytes;
  return rc;
}

extern "C" int lum_gather_sum(const void* tab, long long rows, int cols,
                              const void* idx, long long k_n, void* out,
                              void* stream) {
  if (cols <= 0 || cols > 128 || (cols & 3) != 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  int rc = current_device(&dev);
  if (rc != 0) return rc;
  const size_t bytes = 2 * STAGE * sizeof(float4);
  rc = allow_smem(gather_sum_kernel, bytes, &allowed[dev]);
  if (rc != 0) return rc;
  const int cols4 = cols / 4;
  gather_sum_kernel<<<cols4, SUM_THREADS, bytes, (cudaStream_t)stream>>>(
      (const float4*)tab, rows, cols4, (const int32_t*)idx, k_n, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int lum_gather_chain(const void* tab, int rows, int cols,
                                const void* seed, int steps, void* out,
                                void* stream) {
  if (cols <= 0 || cols > 128 || (cols & 3) != 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  static size_t allowed_table[MAX_DEVICES] = {}, allowed_walk[MAX_DEVICES] = {};
  int dev = 0;
  const int rc_dev = current_device(&dev);
  if (rc_dev != 0) return rc_dev;
  const size_t padded = (size_t)rows + ((size_t)rows >> 5) + 1;
  const size_t walk = 2 * STAGE * sizeof(float4) + (SEQ + SEQ / 32 + 1) * sizeof(int);
  const size_t table = walk + 3 * padded * sizeof(int);
  const size_t fixed = (SEQ / JUMP + 1) * sizeof(int);  // static shared
  const int cols4 = cols / 4;
  if (table + fixed <= (size_t)smem_optin(dev)) {
    const int rc = allow_smem(gather_chain_kernel<true>, table, &allowed_table[dev]);
    if (rc != 0) return rc;
    gather_chain_kernel<true><<<cols4, CHAIN_THREADS, table, (cudaStream_t)stream>>>(
        (const float4*)tab, rows, cols4, (const float*)seed, steps, (float*)out);
  } else {
    const int rc = allow_smem(gather_chain_kernel<false>, walk, &allowed_walk[dev]);
    if (rc != 0) return rc;
    gather_chain_kernel<false><<<cols4, CHAIN_THREADS, walk, (cudaStream_t)stream>>>(
        (const float4*)tab, rows, cols4, (const float*)seed, steps, (float*)out);
  }
  return (int)cudaGetLastError();
}
