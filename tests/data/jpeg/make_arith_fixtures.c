/* Writes arithmetic-coded JPEG files (SOF9 sequential, SOF10
 * progressive, DAC conditioning) with libjpeg's own encoder, for the
 * port's decoder tests: libjpeg-turbo 2.1.5 as shipped by Debian, whose
 * static library is built with C_ARITH_CODING_SUPPORTED.
 *
 * Build:
 *   gcc -O2 tests/data/jpeg/make_arith_fixtures.c \
 *       /usr/lib/x86_64-linux-gnu/libjpeg.a -lm -o make_arith_fixtures
 * Run (tests/test_torch_port_jpeg.py's write_fixtures does both):
 *   make_arith_fixtures IN OUT [options]
 * IN is raw samples after a text line "width height channels\n"
 * (1: gray, 3: RGB, 4: CMYK). Options:
 *   -q N        quality (default 90)
 *   -s S        sampling of a colour file: 444, 422 or 420 (default 420;
 *               a CMYK / YCCK file takes 2x2 on its first and last
 *               components under 420)
 *   -r N        restart interval in MCUs (default 0)
 *   -p          jpeg_simple_progression (SOF10)
 *   -d L,U,K    DC conditioning L and U and AC conditioning K of every
 *               table (a DAC segment; default 0,1,5 writes none)
 *   -c ycck     a 4-channel file coded as YCCK (default CMYK)
 *   -S SCRIPT   a scan script: scans separated by '/', each
 *               "components:Ss-Se:Ah:Al", e.g. "0:0-63:0:0/1:0-63:0:0"
 *               (sequential scans of one component each)
 *   -H          Huffman coding in place of arithmetic (a twin file)
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static jpeg_scan_info scans[64];

static int parse_script(const char *s) {
  int n = 0;
  while (*s && n < 64) {
    jpeg_scan_info *si = &scans[n];
    int k = 0;
    while (*s >= '0' && *s <= '3') si->component_index[k++] = *s++ - '0';
    si->comps_in_scan = k;
    if (sscanf(s, ":%d-%d:%d:%d", &si->Ss, &si->Se, &si->Ah, &si->Al) != 4)
      return -1;
    while (*s && *s != '/') ++s;
    if (*s == '/') ++s;
    ++n;
  }
  return n;
}

int main(int argc, char **argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s IN OUT [options]\n", argv[0]);
    return 2;
  }
  int quality = 90, restart = 0, progressive = 0, huffman = 0, nscans = 0;
  int dac = 0, L = 0, U = 1, K = 5, ycck = 0;
  const char *sampling = "420";
  for (int i = 3; i < argc; ++i) {
    if (!strcmp(argv[i], "-q") && i + 1 < argc) quality = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-s") && i + 1 < argc) sampling = argv[++i];
    else if (!strcmp(argv[i], "-r") && i + 1 < argc) restart = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-p")) progressive = 1;
    else if (!strcmp(argv[i], "-H")) huffman = 1;
    else if (!strcmp(argv[i], "-c") && i + 1 < argc) ycck = !strcmp(argv[++i], "ycck");
    else if (!strcmp(argv[i], "-d") && i + 1 < argc) {
      if (sscanf(argv[++i], "%d,%d,%d", &L, &U, &K) != 3) return 2;
      dac = 1;
    } else if (!strcmp(argv[i], "-S") && i + 1 < argc) {
      nscans = parse_script(argv[++i]);
      if (nscans <= 0) return 2;
    } else {
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
  if (ch == 4 && ycck) jpeg_set_colorspace(&cinfo, JCS_YCCK);
  jpeg_set_quality(&cinfo, quality, TRUE);
  if (ch > 1) {
    int hf = !strcmp(sampling, "444") ? 1 : 2;
    int vf = !strcmp(sampling, "420") ? 2 : 1;
    for (int c = 0; c < cinfo.num_components; ++c) {
      int first = c == 0 || c == 3;
      cinfo.comp_info[c].h_samp_factor = first ? hf : 1;
      cinfo.comp_info[c].v_samp_factor = first ? vf : 1;
    }
  }
  cinfo.arith_code = huffman ? FALSE : TRUE;
  cinfo.restart_interval = restart;
  if (dac) {
    for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
      cinfo.arith_dc_L[t] = (UINT8)L;
      cinfo.arith_dc_U[t] = (UINT8)U;
      cinfo.arith_ac_K[t] = (UINT8)K;
    }
  }
  if (progressive) jpeg_simple_progression(&cinfo);
  if (nscans) {
    cinfo.scan_info = scans;
    cinfo.num_scans = nscans;
  }
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
