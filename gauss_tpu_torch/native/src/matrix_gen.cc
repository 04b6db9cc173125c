// Standalone synthetic-matrix generator tool (reference component C7).
//
// Emits to stdout, in the .dat coordinate format, the same matrix family the
// reference's generator produces (reference
// Pthreads/Version-1/matrices_dense/matrix_gen.cc:13-22): header "n n n*n",
// column-major body of 1-indexed entries with value 2*min(row, col), and the
// "0 0 0" terminator line. Usage: ./matrix_gen <n> [> file.dat]

#include <cstdio>
#include <cstdlib>
#include <cstring>

int main(int argc, char** argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: %s <n>\n", argv[0]);
    return 1;
  }
  char* end = nullptr;
  long n = std::strtol(argv[1], &end, 10);
  if (end == argv[1] || *end != '\0' || n <= 0) {
    std::fprintf(stderr, "%s: n must be a positive integer, got '%s'\n", argv[0], argv[1]);
    return 1;
  }
  std::printf("%ld %ld %ld\n", n, n, n * n);
  for (long col = 1; col <= n; ++col)
    for (long row = 1; row <= n; ++row)
      std::printf("%ld %ld %ld\n", row, col, 2 * (row < col ? row : col));
  std::printf("0 0 0\n");
  return 0;
}
