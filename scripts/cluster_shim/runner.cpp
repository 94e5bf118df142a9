// Runs chol_cluster.cuh's cluster solve and chol_tiled.cuh's stream_solve
// on one system under the CPU stand-in (cuda_runtime.h here), as
// gather_solve.cuh's kernels call them.  Input (argv[1]): int32 r, int32
// has_add, then float32 S [r·r], add [r·r], b [r], count, ridge, jitter.
// Output (argv[2]): float32 x of the cluster solve [r], x of stream_solve
// [r], then int32 cluster size and int64 shared bytes a block.  With
// --plan alone it prints the cluster plan of every rank 289 .. 512.
#include <cstdio>
#include <memory>
#include <string>
#include <thread>
#include <vector>

#include "chol_cluster.cuh"

// gather_solve.cuh's gsolve::tail
static float tail(int i, int c, float a, float ridge, float jitter,
                  float cnt) {
  if (i == c) a = (a + ridge) + jitter;
  if (cnt <= 0.f) a = (i == c) ? 1.f + jitter : 0.f;
  return a;
}

template <typename Body>
static void run_block_threads(std::vector<shim::Block*>& blocks,
                              shim::Cluster& cl, int threads, Body body) {
  std::vector<std::thread> th;
  for (unsigned c = 0; c < blocks.size(); ++c)
    for (int t = 0; t < threads; ++t)
      th.emplace_back([&, c, t] {
        shim::ctx = shim::Ctx{blocks[c], &cl, c};
        threadIdx = dim3(t);
        blockDim = dim3(threads);
        body(blocks[c]->base());
      });
  for (auto& t : th) t.join();
}

// argv[1] == "--plan": for every rank 289 .. 512, a line "r C bytes
// owner_0 .. owner_{T-1}" (ccl::cluster_size, smem_bytes, owner)
static int print_plans() {
  for (int r = 289; r <= 512; ++r) {
    const int T = cholt::tiles(r), C = ccl::cluster_size(r);
    std::printf("%d %d %lld", r, C, C ? ccl::smem_bytes(T, C) : 0LL);
    for (int I = 0; C && I < T; ++I) std::printf(" %d", ccl::owner(I, T, C));
    std::printf("\n");
  }
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 2 && std::string(argv[1]) == "--plan") return print_plans();
  if (argc != 3) return 2;
  FILE* f = std::fopen(argv[1], "rb");
  int r = 0, has_add = 0;
  if (!f || std::fread(&r, 4, 1, f) != 1 || std::fread(&has_add, 4, 1, f) != 1)
    return 3;
  const size_t rr = static_cast<size_t>(r) * r;
  std::vector<float> S(rr), add(rr), b(r);
  float cnt = 0, ridge = 0, jitter = 0;
  if (std::fread(S.data(), 4, rr, f) != rr ||
      std::fread(add.data(), 4, rr, f) != rr ||
      std::fread(b.data(), 4, r, f) != static_cast<size_t>(r) ||
      std::fread(&cnt, 4, 1, f) != 1 || std::fread(&ridge, 4, 1, f) != 1 ||
      std::fread(&jitter, 4, 1, f) != 1)
    return 3;
  std::fclose(f);
  const auto row_tail = [&](int i, int c, float a) {
    return tail(i, c, a, ridge, jitter, cnt);
  };
  const bool vec = r % 4 == 0;

  // the cluster solve, as tail_cluster_kernel runs it
  const int T = cholt::tiles(r), C = ccl::cluster_size(r);
  if (C == 0) return 4;
  const long long bytes = ccl::smem_bytes(T, C);
  std::vector<std::unique_ptr<shim::Block>> own;
  std::vector<shim::Block*> blocks;
  for (int c = 0; c < C; ++c) {
    own.push_back(std::make_unique<shim::Block>(ccl::kThreads, bytes / 4));
    blocks.push_back(own.back().get());
  }
  shim::Cluster cl;
  cl.bar = std::make_unique<shim::Barrier>(C * ccl::kThreads);
  cl.blocks = blocks;
  std::vector<float> xc(r, NAN);
  run_block_threads(blocks, cl, ccl::kThreads, [&](float* smem) {
    if (has_add)
      ccl::solve<true>(S.data(), r, add.data(), b.data(), xc.data(), smem,
                       vec, row_tail);
    else
      ccl::solve<false>(S.data(), r, nullptr, b.data(), xc.data(), smem, vec,
                        row_tail);
  });

  // stream_solve on A formed in place, as the streamed pass did
  std::vector<float> A(S);
  for (int i = 0; i < r; ++i)
    for (int c = 0; c <= i; ++c)
      A[i * r + c] = row_tail(i, c, has_add ? A[i * r + c] + add[i * r + c]
                                            : A[i * r + c]);
  shim::Block one(cholt::kStreamThreads, cholt::kStreamSmemFloats);
  std::vector<shim::Block*> ones{&one};
  shim::Cluster single;
  single.bar = std::make_unique<shim::Barrier>(cholt::kStreamThreads);
  single.blocks = ones;
  std::vector<float> xs(r, NAN);
  run_block_threads(ones, single, cholt::kStreamThreads, [&](float* smem) {
    cholt::stream_solve<false, true>(A.data(), r, b.data(), xs.data(), smem,
                                     vec);
  });

  f = std::fopen(argv[2], "wb");
  if (!f) return 5;
  std::fwrite(xc.data(), 4, r, f);
  std::fwrite(xs.data(), 4, r, f);
  std::fwrite(&C, 4, 1, f);
  std::fwrite(&bytes, 8, 1, f);
  std::fclose(f);
  return 0;
}
