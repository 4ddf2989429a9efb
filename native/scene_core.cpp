// Native scene-graph runtime core.
//
// Native counterpart of the reference's native scene layer
// (IoniqRE/scene.{h,cu}, model.{h,cu}, mesh.{h,cu}): the compute path is
// JAX/XLA/Pallas, but the runtime around it — scene CRUD, procedural mesh
// generation, TRS transform caching, and flattening the scene into the SoA
// packet the device consumes — is C++ just like the reference's. Exposed as
// a C ABI consumed from Python via ctypes (ptre/models/native_scene.py).
//
// Semantics mirrored from the reference:
//   * name→mesh / name→model maps; models iterated sorted by mesh name with
//     insertion-order tie-break (scene.h:58-68);
//   * duplicate inserts silently refuse (scene.cu:15-22);
//   * model transform = S · Rx · Ry · Rz · T, row-vector convention
//     (model.cu:11-18, matrix.cu:359-423);
//   * SPHERES-type models flatten to analytic spheres with radius = scale.x,
//     center = translation (scene.cu:176-177); TRIANGLES models flatten to a
//     (transform, gathered-triangle) drawcall (scene.cu:121-181);
//   * a modified flag gates packet rebuild (scene.h:96, scene.cu:112);
//   * mesh generators reproduce mesh.cu:66-279 topologies exactly.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTau = 2.0f * kPi;

struct Vec3 {
  float x, y, z;
};

// 4x4 row-vector matrix (row 3 = translation), matching iqmat conventions.
struct Mat4 {
  float m[4][4];
  Mat4() { identity(); }
  void identity() {
    std::memset(m, 0, sizeof(m));
    m[0][0] = m[1][1] = m[2][2] = m[3][3] = 1.0f;
  }
  static Mat4 scale(float sx, float sy, float sz) {
    Mat4 r;
    r.m[0][0] = sx; r.m[1][1] = sy; r.m[2][2] = sz;
    return r;
  }
  static Mat4 translate(float tx, float ty, float tz) {
    Mat4 r;
    r.m[3][0] = tx; r.m[3][1] = ty; r.m[3][2] = tz;
    return r;
  }
  static Mat4 rot_x(float a) {  // matrix.cu:375-385
    Mat4 r;
    float s = std::sin(a), c = std::cos(a);
    r.m[1][1] = c; r.m[1][2] = s; r.m[2][1] = -s; r.m[2][2] = c;
    return r;
  }
  static Mat4 rot_y(float a) {  // matrix.cu:387-397
    Mat4 r;
    float s = std::sin(a), c = std::cos(a);
    r.m[0][0] = c; r.m[0][2] = -s; r.m[2][0] = s; r.m[2][2] = c;
    return r;
  }
  static Mat4 rot_z(float a) {  // matrix.cu:399-409
    Mat4 r;
    float s = std::sin(a), c = std::cos(a);
    r.m[0][0] = c; r.m[0][1] = s; r.m[1][0] = -s; r.m[1][1] = c;
    return r;
  }
  Mat4 operator*(const Mat4& o) const {  // matrix.cu:62-82
    Mat4 r;
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) {
        float acc = 0;
        for (int k = 0; k < 4; k++) acc += m[i][k] * o.m[k][j];
        r.m[i][j] = acc;
      }
    return r;
  }
};

Vec3 rot_point_z(const Vec3& p, float a) {  // row-vector v @ Rz
  float s = std::sin(a), c = std::cos(a);
  return {p.x * c - p.y * s, p.x * s + p.y * c, p.z};
}
Vec3 rot_point_y(const Vec3& p, float a) {  // row-vector v @ Ry
  float s = std::sin(a), c = std::cos(a);
  return {p.x * c + p.z * s, p.y, -p.x * s + p.z * c};
}

enum MeshType : int32_t { TRIANGLES = 0, SPHERES = 1 };

struct Mesh {
  std::vector<Vec3> positions;
  std::vector<Vec3> normals;
  std::vector<uint32_t> indices;
  int32_t type = TRIANGLES;
};

struct Model {
  std::string mesh_name;
  float scale[3] = {1, 1, 1};
  float rotation[3] = {0, 0, 0};
  float translation[3] = {0, 0, 0};
  int32_t material = -1;  // -1 → type default
  uint64_t order = 0;     // insertion tie-break (scene.h:64-67)
  Mat4 transform;         // cached (model.h:39)

  void recompute() {  // model.cu:11-18
    Mat4 s = Mat4::scale(scale[0], scale[1], scale[2]);
    Mat4 r = Mat4::rot_x(rotation[0]) * Mat4::rot_y(rotation[1]) *
             Mat4::rot_z(rotation[2]);
    Mat4 t = Mat4::translate(translation[0], translation[1], translation[2]);
    transform = s * r * t;
  }
};

// ---- procedural generators (mesh.cu:66-279) -------------------------------

Mesh gen_tri() {
  Mesh m;
  Vec3 n{0, 0, -1};
  m.positions = {{0, .5f, 0}, {.5f, -.5f, 0}, {-.5f, -.5f, 0}};
  m.normals = {n, n, n};
  m.indices = {0, 1, 2};
  return m;
}

Mesh gen_quad() {
  Mesh m;
  Vec3 n{0, 0, -1};
  m.positions = {{-.5f, -.5f, 0}, {.5f, -.5f, 0}, {.5f, .5f, 0}, {-.5f, .5f, 0}};
  m.normals = {n, n, n, n};
  m.indices = {0, 3, 1, 1, 3, 2};
  return m;
}

Mesh gen_reg_polygon(uint32_t vertices) {  // mesh.cu:100-128
  Mesh m;
  if (vertices < 3) vertices = 3;
  float theta = kTau / vertices;
  Vec3 n{0, 0, -1};
  m.positions.push_back({0, 0, 0});
  Vec3 v{0.5f, 0, 0};
  m.positions.push_back(v);
  for (uint32_t i = 1; i < vertices; i++) {
    v = rot_point_z(v, theta);
    m.positions.push_back(v);
  }
  m.normals.assign(m.positions.size(), n);
  for (uint32_t i = 1; i < vertices; i++) {
    m.indices.push_back(i);
    m.indices.push_back(0);
    m.indices.push_back(i + 1);
  }
  m.indices.push_back((uint32_t)m.positions.size() - 1);
  m.indices.push_back(0);
  m.indices.push_back(1);
  return m;
}

Mesh gen_cube() {  // mesh.cu:130-186
  Mesh m;
  const float h = 0.5f;
  struct F { Vec3 v[4]; Vec3 n; };
  const Vec3 a{-h, -h, -h}, b{h, -h, -h}, c{h, h, -h}, d{-h, h, -h};
  const Vec3 a2{-h, -h, h}, b2{h, -h, h}, c2{h, h, h}, d2{-h, h, h};
  const F faces[6] = {
      {{a, b, c, d}, {0, 0, -1}},      // -Z
      {{a2, b2, c2, d2}, {0, 0, 1}},   // +Z
      {{a2, d, a, d2}, {-1, 0, 0}},    // -X
      {{b, c2, b2, c}, {1, 0, 0}},     // +X
      {{a2, b, b2, a}, {0, -1, 0}},    // -Y
      {{d, c2, c, d2}, {0, 1, 0}},     // +Y
  };
  for (const F& f : faces)
    for (int i = 0; i < 4; i++) {
      m.positions.push_back(f.v[i]);
      m.normals.push_back(f.n);
    }
  m.indices = {0, 2, 1, 0, 3, 2,  5, 7, 4, 5, 6, 7,  8, 9, 10, 8, 11, 9,
               12, 13, 14, 12, 15, 13,  16, 17, 18, 16, 19, 17,
               20, 21, 22, 20, 23, 21};
  return m;
}

Mesh gen_uv_sphere(int flat, uint32_t segments, uint32_t rings,
                   int32_t type) {  // mesh.cu:190-279
  Mesh m;
  m.type = type;
  if (segments < 3) segments = 3;
  if (rings < 3) rings = 3;
  const float theta = kPi / rings;
  const float phi = kTau / segments;
  const Vec3 bottom{0, -1, 0}, top{0, 1, 0};
  Vec3 crt_polar = bottom;
  for (uint32_t i = 1; i < rings; i++) {
    crt_polar = rot_point_z(crt_polar, theta);
    m.positions.push_back(crt_polar);
    Vec3 crt_az = crt_polar;
    for (uint32_t j = 1; j < segments; j++) {
      crt_az = rot_point_y(crt_az, phi);
      m.positions.push_back(crt_az);
    }
  }
  m.positions.push_back(bottom);
  m.positions.push_back(top);
  m.normals = m.positions;  // smooth normals = positions

  for (uint32_t i = 0; i + 2 < rings; i++) {
    for (uint32_t j = 0; j + 1 < segments; j++) {
      m.indices.insert(m.indices.end(),
                       {i * segments + j, i * segments + j + 1,
                        (i + 1) * segments + j + 1});
      m.indices.insert(m.indices.end(),
                       {i * segments + j, (i + 1) * segments + j + 1,
                        (i + 1) * segments + j});
    }
    m.indices.insert(m.indices.end(),
                     {(i + 1) * segments - 1, i * segments, (i + 1) * segments});
    m.indices.insert(m.indices.end(),
                     {(i + 1) * segments - 1, (i + 1) * segments,
                      (i + 2) * segments - 1});
  }
  uint32_t nv = (uint32_t)m.positions.size();
  uint32_t top_idx = nv - 1, bottom_idx = nv - 2;
  for (uint32_t i = 0; i + 1 < segments; i++) {
    m.indices.insert(m.indices.end(), {bottom_idx, i + 1, i});
    m.indices.insert(m.indices.end(), {top_idx, nv - i - 4, nv - i - 3});
  }
  m.indices.insert(m.indices.end(), {bottom_idx, 0, segments - 1});
  m.indices.insert(m.indices.end(), {top_idx, nv - 3, nv - segments - 2});
  if (!flat) return m;

  // flat-shaded variant: per-face outward normals with unshared vertices —
  // the reference declares but never implements this (mesh.cu:198 TODO);
  // same construction as the Python core (models/mesh.py uv_sphere(flat)).
  Mesh f;
  f.type = type;
  const size_t n_faces = m.indices.size() / 3;
  f.positions.reserve(n_faces * 3);
  f.normals.reserve(n_faces * 3);
  f.indices.reserve(n_faces * 3);
  for (size_t fi = 0; fi < n_faces; fi++) {
    const Vec3 a = m.positions[m.indices[3 * fi + 0]];
    const Vec3 b = m.positions[m.indices[3 * fi + 1]];
    const Vec3 c = m.positions[m.indices[3 * fi + 2]];
    const Vec3 e1{b.x - a.x, b.y - a.y, b.z - a.z};
    const Vec3 e2{c.x - a.x, c.y - a.y, c.z - a.z};
    Vec3 n{e1.y * e2.z - e1.z * e2.y, e1.z * e2.x - e1.x * e2.z,
           e1.x * e2.y - e1.y * e2.x};
    // orient outward: away from the (origin-centered) sphere's center,
    // tested against the face centroid
    const Vec3 ctr{(a.x + b.x + c.x) / 3.0f, (a.y + b.y + c.y) / 3.0f,
                   (a.z + b.z + c.z) / 3.0f};
    const float d = n.x * ctr.x + n.y * ctr.y + n.z * ctr.z;
    const float sign = d < 0.0f ? -1.0f : 1.0f;
    const float len =
        std::sqrt(n.x * n.x + n.y * n.y + n.z * n.z);
    const float inv = sign / (len > 1e-20f ? len : 1e-20f);
    n = {n.x * inv, n.y * inv, n.z * inv};
    for (const Vec3& p : {a, b, c}) {
      f.indices.push_back((uint32_t)f.positions.size());
      f.positions.push_back(p);
      f.normals.push_back(n);
    }
  }
  return f;
}

struct Scene {
  std::map<std::string, Mesh> meshes;
  std::map<std::string, Model> models;
  uint64_t next_order = 0;
  bool modified = true;

  // models sorted by (mesh name, insertion order) — scene.h:58-68
  std::vector<const Model*> sorted_models() const {
    std::vector<const Model*> out;
    out.reserve(models.size());
    for (const auto& kv : models) out.push_back(&kv.second);
    std::sort(out.begin(), out.end(), [](const Model* a, const Model* b) {
      if (a->mesh_name != b->mesh_name) return a->mesh_name < b->mesh_name;
      return a->order < b->order;
    });
    return out;
  }
};

}  // namespace

extern "C" {

Scene* ptre_scene_create() { return new Scene(); }
void ptre_scene_destroy(Scene* s) { delete s; }
int ptre_scene_modified(const Scene* s) { return s->modified ? 1 : 0; }

static int add_mesh(Scene* s, const char* name, Mesh&& m) {
  if (s->meshes.count(name)) return 0;  // silent duplicate refusal
  s->meshes.emplace(name, std::move(m));
  s->modified = true;
  return 1;
}

int ptre_scene_add_mesh_tri(Scene* s, const char* n) { return add_mesh(s, n, gen_tri()); }
int ptre_scene_add_mesh_quad(Scene* s, const char* n) { return add_mesh(s, n, gen_quad()); }
int ptre_scene_add_mesh_reg_polygon(Scene* s, const char* n, uint32_t v) {
  return add_mesh(s, n, gen_reg_polygon(v));
}
int ptre_scene_add_mesh_cube(Scene* s, const char* n) { return add_mesh(s, n, gen_cube()); }
int ptre_scene_add_mesh_uv_sphere(Scene* s, const char* n, int flat,
                                  uint32_t segments, uint32_t rings,
                                  int32_t type) {
  return add_mesh(s, n, gen_uv_sphere(flat, segments, rings, type));
}
int ptre_scene_add_mesh_raw(Scene* s, const char* n, const float* pos,
                            const float* nrm, uint32_t nv, const uint32_t* idx,
                            uint32_t ni, int32_t type) {
  Mesh m;
  m.type = type;
  m.positions.resize(nv);
  m.normals.resize(nv);
  std::memcpy(m.positions.data(), pos, nv * sizeof(Vec3));
  std::memcpy(m.normals.data(), nrm, nv * sizeof(Vec3));
  m.indices.assign(idx, idx + ni);
  return add_mesh(s, n, std::move(m));
}

int ptre_scene_rename_mesh(Scene* s, const char* o, const char* n) {
  auto it = s->meshes.find(o);
  if (it == s->meshes.end() || s->meshes.count(n)) return 0;
  Mesh m = std::move(it->second);
  s->meshes.erase(it);
  s->meshes.emplace(n, std::move(m));
  for (auto& kv : s->models)
    if (kv.second.mesh_name == o) kv.second.mesh_name = n;
  s->modified = true;
  return 1;
}

int ptre_scene_delete_mesh(Scene* s, const char* n) {
  for (const auto& kv : s->models)
    if (kv.second.mesh_name == n) return 0;  // still referenced
  if (!s->meshes.erase(n)) return 0;
  s->modified = true;
  return 1;
}

int ptre_scene_mesh_counts(const Scene* s, const char* n, uint32_t* nv,
                           uint32_t* ni, int32_t* type) {
  auto it = s->meshes.find(n);
  if (it == s->meshes.end()) return 0;
  *nv = (uint32_t)it->second.positions.size();
  *ni = (uint32_t)it->second.indices.size();
  *type = it->second.type;
  return 1;
}

int ptre_scene_mesh_data(const Scene* s, const char* n, float* pos, float* nrm,
                         uint32_t* idx) {
  auto it = s->meshes.find(n);
  if (it == s->meshes.end()) return 0;
  const Mesh& m = it->second;
  std::memcpy(pos, m.positions.data(), m.positions.size() * sizeof(Vec3));
  std::memcpy(nrm, m.normals.data(), m.normals.size() * sizeof(Vec3));
  std::memcpy(idx, m.indices.data(), m.indices.size() * sizeof(uint32_t));
  return 1;
}

int ptre_scene_add_model(Scene* s, const char* name, const char* mesh_name) {
  if (s->models.count(name) || !s->meshes.count(mesh_name)) return 0;
  Model m;
  m.mesh_name = mesh_name;
  m.order = s->next_order++;
  m.recompute();
  s->models.emplace(name, std::move(m));
  s->modified = true;
  return 1;
}

int ptre_scene_rename_model(Scene* s, const char* o, const char* n) {
  auto it = s->models.find(o);
  if (it == s->models.end() || s->models.count(n)) return 0;
  Model m = std::move(it->second);
  s->models.erase(it);
  s->models.emplace(n, std::move(m));
  s->modified = true;
  return 1;
}

int ptre_scene_delete_model(Scene* s, const char* n) {
  if (!s->models.erase(n)) return 0;
  s->modified = true;
  return 1;
}

int ptre_scene_set_transforms(Scene* s, const char* model, const float* scale,
                              const float* rot, const float* trans) {
  auto it = s->models.find(model);
  if (it == s->models.end()) return 0;
  std::memcpy(it->second.scale, scale, 3 * sizeof(float));
  std::memcpy(it->second.rotation, rot, 3 * sizeof(float));
  std::memcpy(it->second.translation, trans, 3 * sizeof(float));
  it->second.recompute();
  s->modified = true;
  return 1;
}

int ptre_scene_set_model_material(Scene* s, const char* model, int32_t mat) {
  auto it = s->models.find(model);
  if (it == s->models.end()) return 0;
  it->second.material = mat;
  s->modified = true;
  return 1;
}

int ptre_scene_change_model_mesh(Scene* s, const char* model, const char* mesh) {
  auto it = s->models.find(model);
  if (it == s->models.end() || !s->meshes.count(mesh)) return 0;
  it->second.mesh_name = mesh;
  s->modified = true;
  return 1;
}

// Packet sizing: counts for caller allocation (scene.cu walk, first pass).
void ptre_scene_packet_counts(const Scene* s, int spheres_as_triangles,
                              uint32_t* num_tris, uint32_t* num_spheres,
                              uint32_t* num_drawcalls) {
  uint32_t t = 0, sp = 0, dc = 0;
  for (const Model* m : s->sorted_models()) {
    const Mesh& mesh = s->meshes.at(m->mesh_name);
    if (mesh.type == SPHERES && !spheres_as_triangles) {
      sp++;
    } else {
      t += (uint32_t)mesh.indices.size() / 3;
      dc++;
    }
  }
  *num_tris = t;
  *num_spheres = sp;
  *num_drawcalls = dc;
}

// Packet fill (scene.cu:104-236 flatten): caller-allocated SoA outputs.
// tri_* are (T,3) row-major; transforms (D,16) row-major; clears modified.
int ptre_scene_build_packet(Scene* s, int spheres_as_triangles,
                            int32_t default_tri_mat, int32_t default_sph_mat,
                            float* tri_v0, float* tri_v1, float* tri_v2,
                            float* tri_n0, float* tri_n1, float* tri_n2,
                            int32_t* tri_dc, int32_t* tri_mat,
                            float* transforms, float* sph_center,
                            float* sph_radius, int32_t* sph_mat) {
  uint32_t ti = 0, si = 0, di = 0;
  for (const Model* m : s->sorted_models()) {
    const Mesh& mesh = s->meshes.at(m->mesh_name);
    if (mesh.type == SPHERES && !spheres_as_triangles) {
      sph_center[si * 3 + 0] = m->translation[0];
      sph_center[si * 3 + 1] = m->translation[1];
      sph_center[si * 3 + 2] = m->translation[2];
      sph_radius[si] = m->scale[0];  // scene.cu:176-177
      sph_mat[si] = m->material >= 0 ? m->material : default_sph_mat;
      si++;
    } else {
      std::memcpy(&transforms[di * 16], m->transform.m, 16 * sizeof(float));
      int32_t mat = m->material >= 0 ? m->material : default_tri_mat;
      for (size_t j = 0; j + 2 < mesh.indices.size(); j += 3) {
        const Vec3* corners[3] = {&mesh.positions[mesh.indices[j]],
                                  &mesh.positions[mesh.indices[j + 1]],
                                  &mesh.positions[mesh.indices[j + 2]]};
        const Vec3* norms[3] = {&mesh.normals[mesh.indices[j]],
                                &mesh.normals[mesh.indices[j + 1]],
                                &mesh.normals[mesh.indices[j + 2]]};
        std::memcpy(&tri_v0[ti * 3], corners[0], sizeof(Vec3));
        std::memcpy(&tri_v1[ti * 3], corners[1], sizeof(Vec3));
        std::memcpy(&tri_v2[ti * 3], corners[2], sizeof(Vec3));
        std::memcpy(&tri_n0[ti * 3], norms[0], sizeof(Vec3));
        std::memcpy(&tri_n1[ti * 3], norms[1], sizeof(Vec3));
        std::memcpy(&tri_n2[ti * 3], norms[2], sizeof(Vec3));
        tri_dc[ti] = (int32_t)di;
        tri_mat[ti] = mat;
        ti++;
      }
      di++;
    }
  }
  s->modified = false;  // scene.cu:112
  return 1;
}

}  // extern "C"
