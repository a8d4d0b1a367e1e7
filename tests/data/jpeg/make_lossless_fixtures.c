/* Writes lossless JPEG files (SOF3: DPCM predictors 1-7, point
 * transforms, restart intervals) with libjpeg's own encoder, for the
 * port's decoder tests. Lossless coding arrived in libjpeg-turbo 3.0; the
 * one here is the libjpeg-turbo 3.1 that Pillow bundles, whose encoder
 * exports jpeg_enable_lossless. The header is the system's jpeglib.h
 * (libjpeg-turbo 2.1, the same ABI, libjpeg.so.62), which lacks that
 * function, so it is declared below.
 *
 * Build (PILLOW_LIBS: the site-packages/pillow.libs directory):
 *   gcc -O2 tests/data/jpeg/make_lossless_fixtures.c \
 *       $PILLOW_LIBS/libjpeg-*.so.62.* -Wl,-rpath,$PILLOW_LIBS \
 *       -o make_lossless_fixtures
 * Run (tests/test_torch_port_jpeg.py's write_fixtures does both):
 *   make_lossless_fixtures IN OUT [options]
 * IN is raw samples after a text line "width height channels\n"
 * (1: gray, 3: RGB, 4: CMYK). Options:
 *   -p N        predictor selection value 1-7 (default 1)
 *   -t N        point transform 0-7 (default 0)
 *   -r N        restart interval in MCUs (default 0)
 *   -R N        restart interval in MCU rows (default 0)
 *   -b N        data precision in bits, 2-8 (default 8)
 *   -c SPACE    the colour space coded: "same" (the input's, no
 *               conversion; default), "ycc" (YCbCr from RGB, or YCCK
 *               from CMYK)
 *   -s S        sampling of a colour file: 444, 422 or 420 (default 444)
 *   -a          arithmetic coding (SOF11), which this encoder refuses
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                          int point_transform);

int main(int argc, char **argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s IN OUT [options]\n", argv[0]);
    return 2;
  }
  int predictor = 1, pt = 0, restart = 0, restart_rows = 0, bits = 8;
  int arith = 0;
  const char *space = "same", *sampling = "444";
  for (int i = 3; i < argc; ++i) {
    if (!strcmp(argv[i], "-p") && i + 1 < argc) predictor = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-t") && i + 1 < argc) pt = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-r") && i + 1 < argc) restart = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-R") && i + 1 < argc)
      restart_rows = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-b") && i + 1 < argc) bits = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-c") && i + 1 < argc) space = argv[++i];
    else if (!strcmp(argv[i], "-s") && i + 1 < argc) sampling = argv[++i];
    else if (!strcmp(argv[i], "-a")) arith = 1;
    else {
      fprintf(stderr, "bad option %s\n", argv[i]);
      return 2;
    }
  }
  FILE *in = fopen(argv[1], "rb");
  if (!in) return 1;
  int w, h, ch;
  if (fscanf(in, "%d %d %d", &w, &h, &ch) != 3 || fgetc(in) != '\n') return 1;
  size_t size = (size_t)w * h * ch;
  unsigned char *px = malloc(size);
  if (fread(px, 1, size, in) != size) return 1;
  fclose(in);
  if (bits < 8)  /* samples of fewer bits: keep the top ones */
    for (size_t i = 0; i < size; ++i) px[i] >>= 8 - bits;

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  FILE *out = fopen(argv[2], "wb");
  if (!out) return 1;
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = ch;
  cinfo.in_color_space = ch == 1 ? JCS_GRAYSCALE : ch == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&cinfo);
  cinfo.data_precision = bits;
  if (!strcmp(space, "same"))
    jpeg_set_colorspace(&cinfo, cinfo.in_color_space);
  else if (ch == 4)
    jpeg_set_colorspace(&cinfo, JCS_YCCK);
  if (ch > 1) {
    int hf = !strcmp(sampling, "444") ? 1 : 2;
    int vf = !strcmp(sampling, "420") ? 2 : 1;
    for (int c = 0; c < cinfo.num_components; ++c) {
      int first = c == 0 || c == 3;
      cinfo.comp_info[c].h_samp_factor = first ? hf : 1;
      cinfo.comp_info[c].v_samp_factor = first ? vf : 1;
    }
  }
  jpeg_enable_lossless(&cinfo, predictor, pt);
  cinfo.arith_code = arith ? TRUE : FALSE;
  cinfo.restart_interval = restart;
  cinfo.restart_in_rows = restart_rows;
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = px + (size_t)cinfo.next_scanline * w * ch;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(px);
  return 0;
}
