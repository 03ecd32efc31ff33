/* PNG's five row filters undone on the host (PNG specification, section
 * 9: None, Sub, Up, Average, Paeth). Each byte's prediction reads the
 * reconstructed bytes to its left (a), above (b) and above-left (c), so
 * a row is a recurrence along x: one pass, byte by byte.
 *
 * rows: h rows of 1 + w * bpp bytes, each row's filter type first.
 * out:  h rows of w * bpp bytes.
 * Returns 0, or 1 + the first row whose filter type is not 0 - 4. */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

int kmt_png_unfilter(const uint8_t* rows, uint8_t* out, int h, int w,
                     int bpp) {
  const size_t stride = (size_t)w * bpp;
  for (int y = 0; y < h; ++y) {
    const uint8_t* x = rows + (size_t)y * (stride + 1);
    const int f = *x++;
    uint8_t* cur = out + (size_t)y * stride;
    const uint8_t* up = y ? cur - stride : NULL;
    if (f > 4) return y + 1;
    for (size_t i = 0; i < stride; ++i) {
      const int a = i >= (size_t)bpp ? cur[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = up && i >= (size_t)bpp ? up[i - bpp] : 0;
      int p = 0;
      if (f == 1) {
        p = a;
      } else if (f == 2) {
        p = b;
      } else if (f == 3) {
        p = (a + b) >> 1;
      } else if (f == 4) {
        const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
        p = pa <= pb && pa <= pc ? a : (pb <= pc ? b : c);
      }
      cur[i] = (uint8_t)(x[i] + p);
    }
  }
  return 0;
}
