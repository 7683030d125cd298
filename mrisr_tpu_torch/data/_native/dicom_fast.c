/* Native DICOM header scanner: the hot loop of dataset ingest.
 *
 * The port's copy of mrisr_tpu/data/_native/dicom_fast.c.  Its semantics
 * mirror mrisr_tpu_torch/data/dicom_lite.py:parse_dicom_bytes exactly (the
 * same supported subset: part-10 or raw, Implicit/Explicit VR LE,
 * defined/undefined sequence skipping, uncompressed PixelData, stop at
 * pixel data).  The Python parser is the reference implementation, and
 * tests/test_torch_port_dicom_fast.py asserts identical results.  This
 * translation exists because packing the real Prostate-MRI-US-Biopsy tree
 * means scanning ~69k files (1,151 patients x 60 slices), where the
 * per-element Python overhead dominates (the reference paid the same cost
 * inside SimpleITK's C++ reader, reference/src/ModelDataGenerator.py:33).
 *
 * Host code, not a device kernel: data/dicom_fast.py builds it on first use
 * with the system C compiler (cc -O2 -shared -fPIC) into build/native/; no
 * external dependencies.
 */

#include <stdint.h>
#include <string.h>

#define ERR_NONE 0
#define ERR_COMPRESSED 1

typedef struct {
  int32_t ok;
  int32_t err;
  /* numeric US-tag fields; -1 = absent */
  int32_t rows, cols, bits_allocated, pixel_representation;
  int32_t samples_per_pixel, bits_stored, high_bit;
  /* pixel data location; -1 = absent */
  int64_t pixel_off, pixel_len;
  /* string fields, NUL-terminated, truncated to capacity; len -1 = absent */
  char modality[68];
  char series_description[132];
  char patient_id[68];
  char study_uid[132];
  char series_uid[132];
  char instance_number[36];
  char image_position[132];
  char image_orientation[196];
  char pixel_spacing[68];
  char rescale_intercept[36];
  char rescale_slope[36];
} DicomHeader;

typedef struct {
  const uint8_t *d;
  int64_t n;
  int64_t p;
} Reader;

static int u16(Reader *r, uint32_t *out) {
  if (r->p + 2 > r->n) return 0;
  *out = (uint32_t)r->d[r->p] | ((uint32_t)r->d[r->p + 1] << 8);
  r->p += 2;
  return 1;
}

static int u32(Reader *r, uint32_t *out) {
  if (r->p + 4 > r->n) return 0;
  *out = (uint32_t)r->d[r->p] | ((uint32_t)r->d[r->p + 1] << 8) |
         ((uint32_t)r->d[r->p + 2] << 16) | ((uint32_t)r->d[r->p + 3] << 24);
  r->p += 4;
  return 1;
}

/* VRs with 2-byte reserved + 4-byte length in explicit encoding */
static int is_long_vr(const uint8_t *vr) {
  switch (vr[0]) {
    case 'O':
      return vr[1] == 'B' || vr[1] == 'W' || vr[1] == 'F' || vr[1] == 'L' ||
             vr[1] == 'D';
    case 'S':
      return vr[1] == 'Q';
    case 'U':
      return vr[1] == 'C' || vr[1] == 'R' || vr[1] == 'T' || vr[1] == 'N';
    default:
      return 0;
  }
}

/* copy a raw string value into a fixed field, strip NUL/space padding the
 * way Python's .strip("\x00 ").strip() does */
static void set_str(char *dst, int cap, const uint8_t *src, int64_t len) {
  int64_t a = 0, b = len;
  while (a < b && (src[a] == 0 || src[a] == ' ' || src[a] == '\t' ||
                   src[a] == '\r' || src[a] == '\n'))
    a++;
  while (b > a && (src[b - 1] == 0 || src[b - 1] == ' ' ||
                   src[b - 1] == '\t' || src[b - 1] == '\r' ||
                   src[b - 1] == '\n'))
    b--;
  int64_t m = b - a;
  if (m > cap - 1) m = cap - 1;
  memcpy(dst, src + a, (size_t)m);
  dst[m] = 0;
}

/* skip an undefined-length SQ (mirrors _skip_undefined_sequence) */
static int skip_undefined_sequence(Reader *r, int explicit_vr) {
  int depth = 1;
  while (depth > 0 && r->p < r->n) {
    uint32_t group, elem, length;
    if (!u16(r, &group) || !u16(r, &elem)) return 0;
    if (group == 0xFFFE && elem == 0xE000) { /* item start */
      if (!u32(r, &length)) return 0;
      if (length == 0xFFFFFFFF)
        depth++;
      else
        r->p += length;
    } else if (group == 0xFFFE && (elem == 0xE00D || elem == 0xE0DD)) {
      if (!u32(r, &length)) return 0;
      depth--;
    } else {
      if (explicit_vr) {
        if (r->p + 2 > r->n) return 0;
        const uint8_t *vr = r->d + r->p;
        r->p += 2;
        if (is_long_vr(vr)) {
          r->p += 2;
          if (!u32(r, &length)) return 0;
        } else {
          uint32_t l16;
          if (!u16(r, &l16)) return 0;
          length = l16;
        }
      } else {
        if (!u32(r, &length)) return 0;
      }
      if (length == 0xFFFFFFFF)
        depth++;
      else
        r->p += length;
    }
  }
  return 1;
}

int parse_dicom(const uint8_t *data, int64_t n, DicomHeader *out) {
  memset(out, 0, sizeof(*out));
  out->rows = out->cols = out->bits_allocated = -1;
  out->pixel_representation = -1;
  out->samples_per_pixel = out->bits_stored = out->high_bit = -1;
  out->pixel_off = out->pixel_len = -1;

  Reader r = {data, n, 0};
  if (n > 132 && memcmp(data + 128, "DICM", 4) == 0) r.p = 132;

  /* transfer syntax: default Explicit VR LE; Implicit = 1.2.840.10008.1.2 */
  int explicit_vr = 1;
  int in_meta = 1;
  int ts_implicit = 0;
  int ts_explicit_le = 1; /* stays 1 while TS is defaulted or exactly EVR-LE */

  while (r.p < r.n) {
    if (r.p + 8 > r.n) break;
    uint32_t group, elem, length;
    if (!u16(&r, &group) || !u16(&r, &elem)) break;

    if (in_meta && group != 0x0002) {
      in_meta = 0;
      explicit_vr = !ts_implicit;
      if (explicit_vr && ts_explicit_le) {
        /* Raw datasets (no part-10 header) carry no TransferSyntaxUID, so
         * EXPLICIT stayed defaulted; sniff the first dataset element —
         * explicit VR places a two-uppercase-letter VR code right after
         * the tag, implicit places a 4-byte length there
         * (mirrors dicom_lite.py's sniff). */
        if (r.p + 2 > r.n ||
            !(r.d[r.p] >= 'A' && r.d[r.p] <= 'Z' && r.d[r.p + 1] >= 'A' &&
              r.d[r.p + 1] <= 'Z'))
          explicit_vr = 0;
      }
    }
    int cur_explicit = (group == 0x0002) ? 1 : explicit_vr;

    uint8_t vr[2] = {'U', 'N'};
    if (cur_explicit) {
      if (r.p + 2 > r.n) break;
      vr[0] = r.d[r.p];
      vr[1] = r.d[r.p + 1];
      r.p += 2;
      if (is_long_vr(vr)) {
        r.p += 2;
        if (!u32(&r, &length)) break;
      } else {
        uint32_t l16;
        if (!u16(&r, &l16)) break;
        length = l16;
      }
    } else {
      if (!u32(&r, &length)) break;
    }

    int is_pixel = (group == 0x7FE0 && elem == 0x0010);

    if ((vr[0] == 'S' && vr[1] == 'Q') ||
        (length == 0xFFFFFFFF && !is_pixel)) {
      if (length == 0xFFFFFFFF) {
        if (!skip_undefined_sequence(&r, cur_explicit)) break;
      } else {
        r.p += length;
      }
      continue;
    }

    if (length == 0xFFFFFFFF) { /* encapsulated pixel data */
      out->err = ERR_COMPRESSED;
      return 0;
    }

    if (r.p + (int64_t)length > r.n) length = (uint32_t)(r.n - r.p);
    const uint8_t *raw = r.d + r.p;
    int64_t off = r.p;
    r.p += length;

    if (group == 0x0002 && elem == 0x0010) {
      /* transfer syntax UID (strip padding, compare) */
      char ts[68];
      set_str(ts, sizeof ts, raw, length);
      ts_implicit = strcmp(ts, "1.2.840.10008.1.2") == 0;
      ts_explicit_le = strcmp(ts, "1.2.840.10008.1.2.1") == 0;
    } else if (is_pixel) {
      out->pixel_off = off;
      out->pixel_len = length;
      break; /* pixel data is last */
    } else if (group == 0x0008 && elem == 0x0060) {
      set_str(out->modality, sizeof out->modality, raw, length);
    } else if (group == 0x0008 && elem == 0x103E) {
      set_str(out->series_description, sizeof out->series_description, raw,
              length);
    } else if (group == 0x0010 && elem == 0x0020) {
      set_str(out->patient_id, sizeof out->patient_id, raw, length);
    } else if (group == 0x0020 && elem == 0x000D) {
      set_str(out->study_uid, sizeof out->study_uid, raw, length);
    } else if (group == 0x0020 && elem == 0x000E) {
      set_str(out->series_uid, sizeof out->series_uid, raw, length);
    } else if (group == 0x0020 && elem == 0x0013) {
      set_str(out->instance_number, sizeof out->instance_number, raw, length);
    } else if (group == 0x0020 && elem == 0x0032) {
      set_str(out->image_position, sizeof out->image_position, raw, length);
    } else if (group == 0x0020 && elem == 0x0037) {
      set_str(out->image_orientation, sizeof out->image_orientation, raw,
              length);
    } else if (group == 0x0028 && elem == 0x0030) {
      set_str(out->pixel_spacing, sizeof out->pixel_spacing, raw, length);
    } else if (group == 0x0028 && elem == 0x1052) {
      set_str(out->rescale_intercept, sizeof out->rescale_intercept, raw,
              length);
    } else if (group == 0x0028 && elem == 0x1053) {
      set_str(out->rescale_slope, sizeof out->rescale_slope, raw, length);
    } else if (group == 0x0028) {
      /* binary US tags */
      uint32_t v = (length >= 2)
                       ? ((uint32_t)raw[0] | ((uint32_t)raw[1] << 8))
                       : 0xFFFFFFFF;
      if (v != 0xFFFFFFFF) {
        switch (elem) {
          case 0x0010: out->rows = (int32_t)v; break;
          case 0x0011: out->cols = (int32_t)v; break;
          case 0x0100: out->bits_allocated = (int32_t)v; break;
          case 0x0103: out->pixel_representation = (int32_t)v; break;
          case 0x0002: out->samples_per_pixel = (int32_t)v; break;
          case 0x0101: out->bits_stored = (int32_t)v; break;
          case 0x0102: out->high_bit = (int32_t)v; break;
          default: break;
        }
      }
    }
  }
  out->ok = 1;
  return 1;
}
