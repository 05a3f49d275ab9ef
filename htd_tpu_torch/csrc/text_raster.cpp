// Glyph rasterisation and blending as OpenCV 5's putText does them.
//
// OpenCV 5 draws text through its copy of stb_truetype: a glyph's outline
// (lines and quadratic curves in font units) is flattened to line segments
// within 0.35 pixel of the curve, the segments are scan-converted by stb's
// exact-area ("v2") rasteriser, and each coverage value is blended into the
// image as round((dst * (255 - a) + color * a) / 255). This file is that
// pipeline: htd_text_glyph takes the outline (built in Python by
// utils/text.py), rasterises it as OpenCV's stbtt_GetGlyphBitmapSubpixel
// does (into the glyph's box padded on every side by max(ceil(w / 10),
// ceil(h / 10)) + 10 pixels, the outline shifted by that padding: the
// padding changes no coverage, but the float32 rounding of every edge
// position depends on it) and blends the bitmap into a uint8 image at an
// integer position, clipped to the image.
// The float arithmetic follows stb_truetype step for step (no fused
// multiply-adds: the host library is built with -ffp-contract=off), so the
// coverage values are the library's own.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { kMove = 1, kLine = 2, kCurve = 3 };

struct Point { float x, y; };

struct Edge { float x0, y0, x1, y1; int invert; };

struct Active {
  Active* next;
  float fx, fdx, fdy, direction, sy, ey;
};

// stbtt__tesselate_curve: split a quadratic until its midpoint lies within
// the flatness of the chord.
void tesselate(std::vector<Point>& pts, float x0, float y0, float x1, float y1, float x2,
               float y2, float flatness_sq, int n) {
  float mx = (x0 + 2 * x1 + x2) / 4;
  float my = (y0 + 2 * y1 + y2) / 4;
  float dx = (x0 + x2) / 2 - mx;
  float dy = (y0 + y2) / 2 - my;
  if (n > 16) return;
  if (dx * dx + dy * dy > flatness_sq) {
    tesselate(pts, x0, y0, (x0 + x1) / 2.0f, (y0 + y1) / 2.0f, mx, my, flatness_sq, n + 1);
    tesselate(pts, mx, my, (x1 + x2) / 2.0f, (y1 + y2) / 2.0f, x2, y2, flatness_sq, n + 1);
  } else {
    pts.push_back({x2, y2});
  }
}

// stbtt__sort_edges: its quicksort, then insertion sort, by top y. The order
// of equal keys decides the order of the active list, so the same sort is kept.
inline bool edge_less(const Edge& a, const Edge& b) { return a.y0 < b.y0; }

void sort_edges_quick(Edge* p, int n) {
  while (n > 12) {
    Edge t;
    int m = n >> 1;
    int c01 = edge_less(p[0], p[m]);
    int c12 = edge_less(p[m], p[n - 1]);
    if (c01 != c12) {
      int c = edge_less(p[0], p[n - 1]);
      int z = (c == c12) ? 0 : n - 1;
      t = p[z]; p[z] = p[m]; p[m] = t;
    }
    t = p[0]; p[0] = p[m]; p[m] = t;
    int i = 1, j = n - 1;
    for (;;) {
      for (;; ++i) if (!edge_less(p[i], p[0])) break;
      for (;; --j) if (!edge_less(p[0], p[j])) break;
      if (i >= j) break;
      t = p[i]; p[i] = p[j]; p[j] = t;
      ++i;
      --j;
    }
    if (j < n - i) {
      sort_edges_quick(p, j);
      p = p + i;
      n = n - i;
    } else {
      sort_edges_quick(p + i, n - i);
      n = j;
    }
  }
}

void sort_edges(Edge* p, int n) {
  sort_edges_quick(p, n);
  for (int i = 1; i < n; ++i) {
    Edge t = p[i];
    int j = i;
    while (j > 0 && edge_less(t, p[j - 1])) {
      p[j] = p[j - 1];
      --j;
    }
    if (i != j) p[j] = t;
  }
}

void handle_clipped_edge(float* scanline, int x, const Active* e, float x0, float y0, float x1,
                         float y1) {
  if (y0 == y1) return;
  if (y0 > e->ey) return;
  if (y1 < e->sy) return;
  if (y0 < e->sy) {
    x0 += (x1 - x0) * (e->sy - y0) / (y1 - y0);
    y0 = e->sy;
  }
  if (y1 > e->ey) {
    x1 += (x1 - x0) * (e->ey - y1) / (y1 - y0);
    y1 = e->ey;
  }
  if (x0 <= x && x1 <= x)
    scanline[x] += e->direction * (y1 - y0);
  else if (x0 >= x + 1 && x1 >= x + 1)
    ;
  else
    scanline[x] += e->direction * (y1 - y0) * (1 - ((x0 - x) + (x1 - x)) / 2);
}

inline float sized_trapezoid_area(float height, float top_width, float bottom_width) {
  return (top_width + bottom_width) / 2.0f * height;
}

inline float position_trapezoid_area(float height, float tx0, float tx1, float bx0, float bx1) {
  return sized_trapezoid_area(height, tx1 - tx0, bx1 - bx0);
}

inline float sized_triangle_area(float height, float width) { return height * width / 2; }

// stbtt__fill_active_edges_new: the signed area each active edge covers in
// the scanline [y_top, y_top + 1), into `scanline`, and the area it leaves
// to the pixels on its right, into `fill`.
void fill_active_edges(float* scanline, float* fill, int len, Active* e, float y_top) {
  float y_bottom = y_top + 1;
  for (; e; e = e->next) {
    if (e->fdx == 0) {
      float x0 = e->fx;
      if (x0 < len) {
        if (x0 >= 0) {
          handle_clipped_edge(scanline, (int)x0, e, x0, y_top, x0, y_bottom);
          handle_clipped_edge(fill - 1, (int)x0 + 1, e, x0, y_top, x0, y_bottom);
        } else {
          handle_clipped_edge(fill - 1, 0, e, x0, y_top, x0, y_bottom);
        }
      }
      continue;
    }
    float x0 = e->fx, dx = e->fdx, xb = x0 + dx, x_top, x_bottom, sy0, sy1, dy = e->fdy;
    if (e->sy > y_top) {
      x_top = x0 + dx * (e->sy - y_top);
      sy0 = e->sy;
    } else {
      x_top = x0;
      sy0 = y_top;
    }
    if (e->ey < y_bottom) {
      x_bottom = x0 + dx * (e->ey - y_top);
      sy1 = e->ey;
    } else {
      x_bottom = xb;
      sy1 = y_bottom;
    }
    if (x_top >= 0 && x_bottom >= 0 && x_top < len && x_bottom < len) {
      if ((int)x_top == (int)x_bottom) {
        int x = (int)x_top;
        float height = (sy1 - sy0) * e->direction;
        scanline[x] += position_trapezoid_area(height, x_top, x + 1.0f, x_bottom, x + 1.0f);
        fill[x] += height;
      } else {
        if (x_top > x_bottom) {
          float t;
          sy0 = y_bottom - (sy0 - y_top);
          sy1 = y_bottom - (sy1 - y_top);
          t = sy0, sy0 = sy1, sy1 = t;
          t = x_bottom, x_bottom = x_top, x_top = t;
          dx = -dx;
          dy = -dy;
          t = x0, x0 = xb, xb = t;
        }
        int x1 = (int)x_top, x2 = (int)x_bottom;
        float y_crossing = y_top + dy * (x1 + 1 - x0);
        float y_final = y_top + dy * (x2 - x0);
        if (y_crossing > y_bottom) y_crossing = y_bottom;
        float sign = e->direction;
        float area = sign * (y_crossing - sy0);
        scanline[x1] += sized_triangle_area(area, x1 + 1 - x_top);
        if (y_final > y_bottom) {
          int denom = x2 - (x1 + 1);
          y_final = y_bottom;
          if (denom != 0) dy = (y_final - y_crossing) / denom;
        }
        float step = sign * dy * 1;
        for (int x = x1 + 1; x < x2; ++x) {
          scanline[x] += area + step / 2;
          area += step;
        }
        scanline[x2] += area + sign * position_trapezoid_area(sy1 - y_final, (float)x2,
                                                              x2 + 1.0f, x_bottom, x2 + 1.0f);
        fill[x2] += sign * (sy1 - sy0);
      }
    } else {
      // The edge leaves the bitmap in this row: clip it pixel by pixel.
      for (int x = 0; x < len; ++x) {
        float y0 = y_top, x1 = (float)x, x2 = (float)(x + 1), x3 = xb, y3 = y_bottom;
        float y1 = (x - x0) / dx + y_top;
        float y2 = (x + 1 - x0) / dx + y_top;
        if (x0 < x1 && x3 > x2) {
          handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
          handle_clipped_edge(scanline, x, e, x1, y1, x2, y2);
          handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
        } else if (x3 < x1 && x0 > x2) {
          handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
          handle_clipped_edge(scanline, x, e, x2, y2, x1, y1);
          handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
        } else if (x0 < x1 && x3 > x1) {
          handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
          handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
        } else if (x3 < x1 && x0 > x1) {
          handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
          handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
        } else if (x0 < x2 && x3 > x2) {
          handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
          handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
        } else if (x3 < x2 && x0 > x2) {
          handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
          handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
        } else {
          handle_clipped_edge(scanline, x, e, x0, y0, x3, y3);
        }
      }
    }
  }
}

// stbtt_Rasterize for one glyph: outline (font units, y up) scaled by
// `scale` and moved by `shift` on both axes, into the w x h bitmap whose
// top-left pixel is (off_x, off_y) in those pixel units (y down).
void rasterize(const int32_t* types, const float* verts, int nv, float scale, float shift,
               int off_x, int off_y, int w, int h, uint8_t* out) {
  float flatness = 0.35f / scale;
  float flatness_sq = flatness * flatness;
  std::vector<Point> pts;
  std::vector<int> lengths;
  int start = 0;
  float x = 0, y = 0;
  for (int i = 0; i < nv; ++i) {
    const float* v = verts + 4 * i;  // x, y, control x, control y
    if (types[i] == kMove) {
      if (i > 0) lengths.push_back((int)pts.size() - start);
      start = (int)pts.size();
      x = v[0];
      y = v[1];
      pts.push_back({x, y});
    } else if (types[i] == kLine) {
      x = v[0];
      y = v[1];
      pts.push_back({x, y});
    } else {
      tesselate(pts, x, y, v[2], v[3], v[0], v[1], flatness_sq, 0);
      x = v[0];
      y = v[1];
    }
  }
  if (nv > 0) lengths.push_back((int)pts.size() - start);

  std::vector<Edge> edges;
  int m = 0;
  for (int len : lengths) {
    const Point* p = pts.data() + m;
    m += len;
    for (int k = 0, j = len - 1; k < len; j = k++) {
      if (p[j].y == p[k].y) continue;
      int a = k, b = j;
      Edge e;
      e.invert = 0;
      if (p[j].y > p[k].y) {  // y is flipped: the edge runs downwards on screen
        e.invert = 1;
        a = j;
        b = k;
      }
      e.x0 = p[a].x * scale + shift;
      e.y0 = p[a].y * -scale + shift;
      e.x1 = p[b].x * scale + shift;
      e.y1 = p[b].y * -scale + shift;
      edges.push_back(e);
    }
  }
  int n = (int)edges.size();
  sort_edges(edges.data(), n);
  Edge sentinel{};
  sentinel.y0 = (float)(off_y + h) + 1;
  edges.push_back(sentinel);

  std::vector<float> buf(2 * (size_t)w + 1);
  float* scanline = buf.data();
  float* scanline2 = scanline + w;
  std::vector<Active> pool(n);
  int used = 0;
  Active* active = nullptr;
  const Edge* e = edges.data();
  for (int j = 0, yy = off_y; j < h; ++j, ++yy) {
    float scan_y_top = yy + 0.0f, scan_y_bottom = yy + 1.0f;
    std::memset(scanline, 0, w * sizeof(float));
    std::memset(scanline2, 0, (w + 1) * sizeof(float));
    for (Active** step = &active; *step;) {
      if ((*step)->ey <= scan_y_top)
        *step = (*step)->next;
      else
        step = &(*step)->next;
    }
    while (e->y0 <= scan_y_bottom) {
      if (e->y0 != e->y1) {
        Active* z = &pool[used++];
        float dxdy = (e->x1 - e->x0) / (e->y1 - e->y0);
        z->fdx = dxdy;
        z->fdy = dxdy != 0.0f ? (1.0f / dxdy) : 0.0f;
        z->fx = e->x0 + dxdy * (scan_y_top - e->y0);
        z->fx -= off_x;
        z->direction = e->invert ? 1.0f : -1.0f;
        z->sy = e->y0;
        z->ey = e->y1;
        if (j == 0 && off_y != 0 && z->ey < scan_y_top) z->ey = scan_y_top;
        z->next = active;
        active = z;
      }
      ++e;
    }
    if (active) fill_active_edges(scanline, scanline2 + 1, w, active, scan_y_top);
    float sum = 0;
    for (int i = 0; i < w; ++i) {
      sum += scanline2[i];
      float k = scanline[i] + sum;
      k = (float)std::fabs(k) * 255 + 0.5f;
      int v = (int)k;
      out[(size_t)j * w + i] = (uint8_t)(v > 255 ? 255 : v);
    }
    for (Active* z = active; z; z = z->next) z->fx += z->fdx;
  }
}

}  // namespace

extern "C" {

// Rasterise one glyph whose box is gw x gh pixels at (box_x, box_y) in glyph
// pixels (floor / ceil of the scaled outline's bounds) into its padded
// bitmap, and blend that into the h x w x c uint8 image (row stride `stride`
// bytes) with the box's top-left pixel at image (dst_x, dst_y), clipped to
// the image. Returns 0.
int htd_text_glyph(uint8_t* img, int h, int w, int c, int64_t stride, const int32_t* types,
                   const float* verts, int nv, float scale, int box_x, int box_y, int gw, int gh,
                   int dst_x, int dst_y, const int32_t* color) {
  if (gw <= 0 || gh <= 0) return 0;
  int pad = std::max((gh + 9) / 10, (gw + 9) / 10) + 10;
  gw += 2 * pad;
  gh += 2 * pad;
  dst_x -= pad;
  dst_y -= pad;
  std::vector<uint8_t> coverage((size_t)gw * gh);
  rasterize(types, verts, nv, scale, (float)pad, box_x, box_y, gw, gh, coverage.data());
  for (int r = 0; r < gh; ++r) {
    int y = dst_y + r;
    if (y < 0 || y >= h) continue;
    uint8_t* row = img + stride * y;
    for (int q = 0; q < gw; ++q) {
      int x = dst_x + q;
      if (x < 0 || x >= w) continue;
      int a = coverage[(size_t)r * gw + q];
      if (!a) continue;
      uint8_t* px = row + (size_t)x * c;
      for (int ch = 0; ch < c; ++ch)
        px[ch] = (uint8_t)((px[ch] * (255 - a) + color[ch] * a + 127) / 255);
    }
  }
  return 0;
}

}  // extern "C"
