// Native z-buffer triangle rasterizer for offline sparse-viewpoint-model generation (a
// copy of m3t_tpu/native/rasterizer.cpp, which made the models the port must equal).
//
// Replaces the reference's OpenGL render path (m3t/src/renderer_geometry.cpp + GLSL
// shaders) for host-side precompute: the Python host transforms triangles to the camera
// frame and this library scan-fills them into depth/id/normal buffers with the math of
// the numpy path of m3t_tpu_torch.ops.raster.rasterize_np (pixel (u, v) samples the
// projected point (u, v); front faces project clockwise, i.e. negative signed area).
//
// Built with contours.cpp by m3t_tpu_torch/native/__init__.py:
// g++ -O3 -march=native -shared -fPIC rasterizer.cpp contours.cpp -o <library>

#include <cmath>
#include <cstdint>
#include <limits>

extern "C" {

// tri_verts: n_tri * 9 floats (camera frame), ids: n_tri, culls: n_tri (1 = backface
// culling enabled for this triangle).  depth must be prefilled with +inf, id_img with 0.
// normals (n_tri * 3 out image, optional): pass nullptr to skip.
void rasterize_soup(const float* tri_verts, const int32_t* ids,
                    const uint8_t* culls, int n_tri, float fu, float fv,
                    float ppu, float ppv, int width, int height, float z_min,
                    float* depth, int32_t* id_img, float* normal_img) {
  for (int t = 0; t < n_tri; ++t) {
    const float* v = tri_verts + t * 9;
    double z0 = v[2], z1 = v[5], z2 = v[8];
    if (z0 <= z_min || z1 <= z_min || z2 <= z_min) continue;

    double u0 = v[0] * fu / z0 + ppu, v0 = v[1] * fv / z0 + ppv;
    double u1 = v[3] * fu / z1 + ppu, v1 = v[4] * fv / z1 + ppv;
    double u2 = v[6] * fu / z2 + ppu, v2 = v[7] * fv / z2 + ppv;

    double area = (u1 - u0) * (v2 - v0) - (v1 - v0) * (u2 - u0);
    if (std::fabs(area) < 1e-12) continue;
    if (culls[t] && area >= 0.0) continue;  // front faces project clockwise

    int umin = (int)std::ceil(std::fmin(u0, std::fmin(u1, u2)));
    int umax = (int)std::floor(std::fmax(u0, std::fmax(u1, u2)));
    int vmin = (int)std::ceil(std::fmin(v0, std::fmin(v1, v2)));
    int vmax = (int)std::floor(std::fmax(v0, std::fmax(v1, v2)));
    if (umin < 0) umin = 0;
    if (vmin < 0) vmin = 0;
    if (umax > width - 1) umax = width - 1;
    if (vmax > height - 1) vmax = height - 1;
    if (umin > umax || vmin > vmax) continue;

    double iz0 = 1.0 / z0, iz1 = 1.0 / z1, iz2 = 1.0 / z2;

    double nx = 0.0, ny = 0.0, nz = 0.0;
    if (normal_img) {
      double e01x = v[3] - v[0], e01y = v[4] - v[1], e01z = v[5] - v[2];
      double e02x = v[6] - v[0], e02y = v[7] - v[1], e02z = v[8] - v[2];
      nx = e01y * e02z - e01z * e02y;
      ny = e01z * e02x - e01x * e02z;
      nz = e01x * e02y - e01y * e02x;
      double norm = std::sqrt(nx * nx + ny * ny + nz * nz);
      if (norm > 1e-12) { nx /= norm; ny /= norm; nz /= norm; }
    }

    for (int py = vmin; py <= vmax; ++py) {
      double gy = (double)py;
      float* depth_row = depth + py * width;
      int32_t* id_row = id_img + py * width;
      for (int px = umin; px <= umax; ++px) {
        double gx = (double)px;
        double w0 = (u2 - u1) * (gy - v1) - (v2 - v1) * (gx - u1);
        double w1 = (u0 - u2) * (gy - v2) - (v0 - v2) * (gx - u2);
        double w2 = (u1 - u0) * (gy - v0) - (v1 - v0) * (gx - u0);
        bool inside = area > 0.0 ? (w0 >= 0.0 && w1 >= 0.0 && w2 >= 0.0)
                                 : (w0 <= 0.0 && w1 <= 0.0 && w2 <= 0.0);
        if (!inside) continue;
        double iz = (w0 * iz0 + w1 * iz1 + w2 * iz2) / area;
        if (iz <= 1e-12) continue;
        float z = (float)(1.0 / iz);
        if (z < depth_row[px]) {
          depth_row[px] = z;
          id_row[px] = ids[t];
          if (normal_img) {
            float* n = normal_img + (py * width + px) * 3;
            n[0] = (float)nx;
            n[1] = (float)ny;
            n[2] = (float)nz;
          }
        }
      }
    }
  }
}

}  // extern "C"
