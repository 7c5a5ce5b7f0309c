// Minimal column-major linear algebra for the scene compiler.
// Conventions follow the flat-buffer contract consumed by the JAX path tracer
// (reference: rust-shader-tools uses glam; layouts documented in SURVEY.md §2.2).
#pragma once
#include <cmath>
#include <cstdint>
#include <algorithm>

namespace wrt {

struct Vec2 {
  float x = 0.f, y = 0.f;
  Vec2() = default;
  Vec2(float x_, float y_) : x(x_), y(y_) {}
  Vec2 operator+(const Vec2& o) const { return {x + o.x, y + o.y}; }
  Vec2 operator-(const Vec2& o) const { return {x - o.x, y - o.y}; }
  Vec2 operator*(float s) const { return {x * s, y * s}; }
};

struct Vec3 {
  float x = 0.f, y = 0.f, z = 0.f;
  Vec3() = default;
  Vec3(float x_, float y_, float z_) : x(x_), y(y_), z(z_) {}
  static Vec3 splat(float v) { return {v, v, v}; }
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
  float& operator[](int i) { return i == 0 ? x : (i == 1 ? y : z); }
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator-() const { return {-x, -y, -z}; }
  Vec3 operator*(float s) const { return {x * s, y * s, z * s}; }
  Vec3 operator*(const Vec3& o) const { return {x * o.x, y * o.y, z * o.z}; }
  Vec3 operator/(float s) const { return {x / s, y / s, z / s}; }
  Vec3& operator+=(const Vec3& o) { x += o.x; y += o.y; z += o.z; return *this; }
  Vec3 min(const Vec3& o) const { return {std::min(x, o.x), std::min(y, o.y), std::min(z, o.z)}; }
  Vec3 max(const Vec3& o) const { return {std::max(x, o.x), std::max(y, o.y), std::max(z, o.z)}; }
  float dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  Vec3 cross(const Vec3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  float length() const { return std::sqrt(dot(*this)); }
  float max_element() const { return std::max(x, std::max(y, z)); }
  Vec3 normalized() const {
    float l = length();
    return l > 0.f ? *this / l : Vec3{0.f, 0.f, 0.f};
  }
  bool is_nan() const { return std::isnan(x) || std::isnan(y) || std::isnan(z); }
};
inline Vec3 operator*(float s, const Vec3& v) { return v * s; }

struct Vec4 {
  float x = 0.f, y = 0.f, z = 0.f, w = 0.f;
  Vec4() = default;
  Vec4(float x_, float y_, float z_, float w_) : x(x_), y(y_), z(z_), w(w_) {}
  Vec4(const Vec3& v, float w_) : x(v.x), y(v.y), z(v.z), w(w_) {}
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : (i == 2 ? z : w)); }
  float& operator[](int i) { return i == 0 ? x : (i == 1 ? y : (i == 2 ? z : w)); }
  Vec4 operator+(const Vec4& o) const { return {x + o.x, y + o.y, z + o.z, w + o.w}; }
  Vec4 operator*(float s) const { return {x * s, y * s, z * s, w * s}; }
  Vec3 xyz() const { return {x, y, z}; }
};

struct Quat {
  // x,y,z imaginary, w real (glTF ordering).
  float x = 0.f, y = 0.f, z = 0.f, w = 1.f;
  Quat() = default;
  Quat(float x_, float y_, float z_, float w_) : x(x_), y(y_), z(z_), w(w_) {}
  float dot(const Quat& o) const { return x * o.x + y * o.y + z * o.z + w * o.w; }
  Quat normalized() const {
    float l = std::sqrt(dot(*this));
    if (l <= 0.f) return Quat();
    return {x / l, y / l, z / l, w / l};
  }
  Quat slerp(const Quat& other, float t) const {
    Quat b = other;
    float d = dot(b);
    if (d < 0.f) { b = {-b.x, -b.y, -b.z, -b.w}; d = -d; }
    if (d > 0.9995f) {
      Quat r{x + (b.x - x) * t, y + (b.y - y) * t, z + (b.z - z) * t, w + (b.w - w) * t};
      return r.normalized();
    }
    float theta0 = std::acos(std::min(1.f, d));
    float theta = theta0 * t;
    float s0 = std::cos(theta) - d * std::sin(theta) / std::sin(theta0);
    float s1 = std::sin(theta) / std::sin(theta0);
    return {x * s0 + b.x * s1, y * s0 + b.y * s1, z * s0 + b.z * s1, w * s0 + b.w * s1};
  }
};

// Column-major 4x4 matrix: m[c][r] is column c, row r; flat layout matches the
// Instance buffer contract (transform packed as 4 consecutive column vec4s).
struct Mat4 {
  float m[4][4] = {{1, 0, 0, 0}, {0, 1, 0, 0}, {0, 0, 1, 0}, {0, 0, 0, 1}};

  static Mat4 identity() { return Mat4(); }
  static Mat4 zero() {
    Mat4 r;
    for (int c = 0; c < 4; ++c)
      for (int i = 0; i < 4; ++i) r.m[c][i] = 0.f;
    return r;
  }
  bool is_zero() const {
    for (int c = 0; c < 4; ++c)
      for (int i = 0; i < 4; ++i)
        if (m[c][i] != 0.f) return false;
    return true;
  }

  static Mat4 from_translation(const Vec3& t) {
    Mat4 r;
    r.m[3][0] = t.x; r.m[3][1] = t.y; r.m[3][2] = t.z;
    return r;
  }
  static Mat4 from_scale(const Vec3& s) {
    Mat4 r;
    r.m[0][0] = s.x; r.m[1][1] = s.y; r.m[2][2] = s.z;
    return r;
  }
  static Mat4 from_rotation_y(float rad) {
    Mat4 r;
    float c = std::cos(rad), s = std::sin(rad);
    r.m[0][0] = c;  r.m[0][2] = -s;
    r.m[2][0] = s;  r.m[2][2] = c;
    return r;
  }
  static Mat4 from_quat(const Quat& q) {
    Mat4 r;
    float x = q.x, y = q.y, z = q.z, w = q.w;
    float x2 = x + x, y2 = y + y, z2 = z + z;
    float xx = x * x2, xy = x * y2, xz = x * z2;
    float yy = y * y2, yz = y * z2, zz = z * z2;
    float wx = w * x2, wy = w * y2, wz = w * z2;
    r.m[0][0] = 1.f - (yy + zz); r.m[0][1] = xy + wz;         r.m[0][2] = xz - wy;
    r.m[1][0] = xy - wz;         r.m[1][1] = 1.f - (xx + zz); r.m[1][2] = yz + wx;
    r.m[2][0] = xz + wy;         r.m[2][1] = yz - wx;         r.m[2][2] = 1.f - (xx + yy);
    return r;
  }
  static Mat4 from_scale_rotation_translation(const Vec3& s, const Quat& q, const Vec3& t) {
    Mat4 r = from_quat(q);
    for (int i = 0; i < 3; ++i) {
      r.m[0][i] *= s.x;
      r.m[1][i] *= s.y;
      r.m[2][i] *= s.z;
    }
    r.m[3][0] = t.x; r.m[3][1] = t.y; r.m[3][2] = t.z;
    return r;
  }

  Mat4 operator*(const Mat4& o) const {
    Mat4 r = Mat4::zero();
    for (int c = 0; c < 4; ++c)
      for (int i = 0; i < 4; ++i) {
        float acc = 0.f;
        for (int k = 0; k < 4; ++k) acc += m[k][i] * o.m[c][k];
        r.m[c][i] = acc;
      }
    return r;
  }
  Mat4 operator*(float s) const {
    Mat4 r = *this;
    for (int c = 0; c < 4; ++c)
      for (int i = 0; i < 4; ++i) r.m[c][i] *= s;
    return r;
  }
  Mat4 operator+(const Mat4& o) const {
    Mat4 r;
    for (int c = 0; c < 4; ++c)
      for (int i = 0; i < 4; ++i) r.m[c][i] = m[c][i] + o.m[c][i];
    return r;
  }

  Vec3 transform_point(const Vec3& p) const {
    return {
        m[0][0] * p.x + m[1][0] * p.y + m[2][0] * p.z + m[3][0],
        m[0][1] * p.x + m[1][1] * p.y + m[2][1] * p.z + m[3][1],
        m[0][2] * p.x + m[1][2] * p.y + m[2][2] * p.z + m[3][2],
    };
  }
  Vec3 transform_vector(const Vec3& v) const {
    return {
        m[0][0] * v.x + m[1][0] * v.y + m[2][0] * v.z,
        m[0][1] * v.x + m[1][1] * v.y + m[2][1] * v.z,
        m[0][2] * v.x + m[1][2] * v.y + m[2][2] * v.z,
    };
  }

  // General 4x4 inverse (cofactor expansion).
  Mat4 inverse() const {
    const float* a = &m[0][0];  // column-major flat
    float inv[16];
    float a00 = a[0], a01 = a[1], a02 = a[2], a03 = a[3];
    float a10 = a[4], a11 = a[5], a12 = a[6], a13 = a[7];
    float a20 = a[8], a21 = a[9], a22 = a[10], a23 = a[11];
    float a30 = a[12], a31 = a[13], a32 = a[14], a33 = a[15];

    float b00 = a00 * a11 - a01 * a10;
    float b01 = a00 * a12 - a02 * a10;
    float b02 = a00 * a13 - a03 * a10;
    float b03 = a01 * a12 - a02 * a11;
    float b04 = a01 * a13 - a03 * a11;
    float b05 = a02 * a13 - a03 * a12;
    float b06 = a20 * a31 - a21 * a30;
    float b07 = a20 * a32 - a22 * a30;
    float b08 = a20 * a33 - a23 * a30;
    float b09 = a21 * a32 - a22 * a31;
    float b10 = a21 * a33 - a23 * a31;
    float b11 = a22 * a33 - a23 * a32;

    float det = b00 * b11 - b01 * b10 + b02 * b09 + b03 * b08 - b04 * b07 + b05 * b06;
    Mat4 r;
    if (det == 0.f) return Mat4::zero();
    float id = 1.f / det;
    inv[0] = (a11 * b11 - a12 * b10 + a13 * b09) * id;
    inv[1] = (a02 * b10 - a01 * b11 - a03 * b09) * id;
    inv[2] = (a31 * b05 - a32 * b04 + a33 * b03) * id;
    inv[3] = (a22 * b04 - a21 * b05 - a23 * b03) * id;
    inv[4] = (a12 * b08 - a10 * b11 - a13 * b07) * id;
    inv[5] = (a00 * b11 - a02 * b08 + a03 * b07) * id;
    inv[6] = (a32 * b02 - a30 * b05 - a33 * b01) * id;
    inv[7] = (a20 * b05 - a22 * b02 + a23 * b01) * id;
    inv[8] = (a10 * b10 - a11 * b08 + a13 * b06) * id;
    inv[9] = (a01 * b08 - a00 * b10 - a03 * b06) * id;
    inv[10] = (a30 * b04 - a31 * b02 + a33 * b00) * id;
    inv[11] = (a21 * b02 - a20 * b04 - a23 * b00) * id;
    inv[12] = (a11 * b07 - a10 * b09 - a12 * b06) * id;
    inv[13] = (a00 * b09 - a01 * b07 + a02 * b06) * id;
    inv[14] = (a31 * b01 - a30 * b03 - a32 * b00) * id;
    inv[15] = (a20 * b03 - a21 * b01 + a22 * b00) * id;
    std::copy(inv, inv + 16, &r.m[0][0]);
    return r;
  }
};

inline float radians(float deg) { return deg * 3.14159265358979323846f / 180.f; }

}  // namespace wrt
